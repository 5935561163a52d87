"""Device-simulator CLI — the `kubectl devsim` plugin, natively
(``iotml.cli.devsim``'s twin).

The reference manages its load-generator fleet with a 500-line kubectl
plugin (`infrastructure/test-generator/kube-cli.sh`): `run` creates a
commander pod from a scenario XML, `jobs/show/log` inspect running
simulations, `abort` tears one down, `example` prints a starter scenario
(usage: `kube-cli.sh:26-47`).  This CLI provides the same verbs with
processes instead of pods:

    python -m iotml_torch.cli.devsim run -s scenario.xml [options]
    python -m iotml_torch.cli.devsim jobs
    python -m iotml_torch.cli.devsim show  <job>
    python -m iotml_torch.cli.devsim log   <job>
    python -m iotml_torch.cli.devsim abort <job>
    python -m iotml_torch.cli.devsim example

`run` executes the scenario against an in-process MQTT broker by default
(deterministic fast mode), or against a real MQTT endpoint with
`--tcp HOST:PORT` (e.g. the broker from `python -m iotml_torch.cli.up`).
`--detach` runs it as a background job tracked under `$IOTML_DEVSIM_DIR`
(default `~/.iotml/devsim`), which is what jobs/show/log/abort manage —
the state directory plays the role the Kubernetes API plays for the
reference plugin.

Scale-down and full scenarios matching the reference's
`scenario_evaluation.xml` / `scenario.xml` ship in
`iotml_torch/gen/scenarios/`.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import uuid

STATE_DIR_ENV = "IOTML_DEVSIM_DIR"

EXAMPLE_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gen", "scenarios",
    "scenario_evaluation.xml")


def _state_dir() -> str:
    d = os.environ.get(STATE_DIR_ENV) or \
        os.path.join(os.path.expanduser("~"), ".iotml", "devsim")
    os.makedirs(d, exist_ok=True)
    return d


def _job_dir(job: str) -> str:
    return os.path.join(_state_dir(), job)


def _load_meta(job: str) -> dict:
    path = os.path.join(_job_dir(job), "job.json")
    if not os.path.exists(path):
        raise SystemExit(f"no such job: {job}")
    with open(path) as fh:
        return json.load(fh)


def _save_meta(job: str, meta: dict) -> None:
    with open(os.path.join(_job_dir(job), "job.json"), "w") as fh:
        json.dump(meta, fh, indent=2)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False


def _job_state(meta: dict) -> str:
    if meta.get("aborted"):
        return "Aborted"
    if _alive(meta["pid"]):
        return "Running"
    return "Completed"


# ------------------------------------------------------------------- verbs

def cmd_run(args) -> int:
    with open(args.scenario) as fh:
        xml_text = fh.read()

    if args.detach:
        job = f"devsim-{time.strftime('%Y%m%d-%H%M%S')}-{uuid.uuid4().hex[:4]}"
        jd = _job_dir(job)
        os.makedirs(jd, exist_ok=True)
        log_path = os.path.join(jd, "job.log")
        child_args = [sys.executable, "-m", "iotml_torch.cli.devsim", "run",
                      "-s", os.path.abspath(args.scenario),
                      "--time-scale", str(args.time_scale),
                      "--encoding", args.encoding]
        if args.tcp:
            child_args += ["--tcp", args.tcp]
        if args.cap:
            child_args += ["--cap", str(args.cap)]
        if args.metrics_port:
            child_args += ["--metrics-port", str(args.metrics_port)]
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(child_args, stdout=log, stderr=log,
                                    start_new_session=True)
        _save_meta(job, {"job": job, "pid": proc.pid,
                         "scenario": os.path.abspath(args.scenario),
                         "tcp": args.tcp, "started": time.time(),
                         "aborted": False})
        print(job)
        return 0

    from ..mqtt.broker import MqttBroker
    from ..mqtt.scenario import ScenarioRunner, parse_scenario

    if args.metrics_port:
        # agent_connect_*/agent_publish_* land in the default registry
        # (reference devsim.json metric families); expose them for scrapes
        from ..obs.metrics import start_http_server
        start_http_server(args.metrics_port)

    scenario = parse_scenario(xml_text)
    if args.cap:
        # scale-down cap, like running the reference scenario under the
        # free license: clamp every group's client/topic/message count
        for g in scenario.client_groups.values():
            g.count = min(g.count, args.cap)
        for g in scenario.topic_groups.values():
            g.count = min(g.count, args.cap)

    transport, port, broker = "inproc", None, MqttBroker()
    if args.tcp:
        host, _, p = args.tcp.rpartition(":")
        scenario.broker_address, scenario.broker_port = host, int(p)
        transport, port = "tcp", int(p)
    runner = ScenarioRunner(scenario, broker, transport=transport, port=port,
                            time_scale=args.time_scale)
    t0 = time.time()
    counts = runner.run(payload_encoding=args.encoding)
    wall = time.time() - t0
    summary = {"scenario": os.path.basename(args.scenario),
               "wall_s": round(wall, 3), **counts,
               "consumers": runner.consumer_counts}
    print(json.dumps(summary))
    return 0


def cmd_jobs(args) -> int:
    rows = []
    for job in sorted(os.listdir(_state_dir())):
        try:
            meta = _load_meta(job)
        except SystemExit:
            continue
        rows.append((job, _job_state(meta),
                     time.strftime("%H:%M:%S",
                                   time.localtime(meta["started"])),
                     meta.get("tcp") or "inproc"))
    if not rows:
        print("no jobs")
        return 0
    print(f"{'JOB':42s} {'STATE':10s} {'STARTED':9s} BROKER")
    for r in rows:
        print(f"{r[0]:42s} {r[1]:10s} {r[2]:9s} {r[3]}")
    return 0


def cmd_show(args) -> int:
    meta = _load_meta(args.job)
    meta["state"] = _job_state(meta)
    log_path = os.path.join(_job_dir(args.job), "job.log")
    if os.path.exists(log_path):
        with open(log_path) as fh:
            tail = fh.readlines()[-5:]
        meta["log_tail"] = [ln.rstrip() for ln in tail]
    print(json.dumps(meta, indent=2))
    return 0


def cmd_log(args) -> int:
    _load_meta(args.job)  # existence check
    log_path = os.path.join(_job_dir(args.job), "job.log")
    if os.path.exists(log_path):
        with open(log_path) as fh:
            sys.stdout.write(fh.read())
    return 0


def cmd_abort(args) -> int:
    meta = _load_meta(args.job)
    if _alive(meta["pid"]):
        try:
            # the detached job leads its own session; signal the whole group
            os.killpg(meta["pid"], signal.SIGTERM)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                os.kill(meta["pid"], signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
    meta["aborted"] = True
    _save_meta(args.job, meta)
    print(f"aborted {args.job}")
    return 0


def cmd_example(args) -> int:
    with open(EXAMPLE_PATH) as fh:
        sys.stdout.write(fh.read())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.cli.devsim",
        description="Scenario-driven device-fleet simulator "
                    "(the reference's kubectl devsim plugin, as processes)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a scenario")
    p.add_argument("-s", "--scenario", required=True)
    p.add_argument("--tcp", metavar="HOST:PORT", default=None,
                   help="publish over real MQTT to this endpoint "
                        "(default: in-process broker, fast mode)")
    p.add_argument("--time-scale", type=float, default=0.0,
                   help="0 = as fast as possible; 1 = real-time rates")
    p.add_argument("--encoding", choices=("json", "avro"), default="json")
    p.add_argument("--cap", type=int, default=0, metavar="N",
                   help="clamp client/topic counts to N (scale-down mode)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve agent_* metrics in Prometheus format")
    p.add_argument("--detach", action="store_true",
                   help="run as a background job (see jobs/show/log/abort)")
    p.set_defaults(fn=cmd_run)

    sub.add_parser("jobs", help="list jobs").set_defaults(fn=cmd_jobs)
    for verb, fn in (("show", cmd_show), ("log", cmd_log),
                     ("abort", cmd_abort)):
        pv = sub.add_parser(verb, help=f"{verb} a job")
        pv.add_argument("job")
        pv.set_defaults(fn=fn)
    sub.add_parser("example", help="print an example scenario XML") \
        .set_defaults(fn=cmd_example)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
