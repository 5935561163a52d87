"""``python -m iotml_torch.mlops`` — the model-lifecycle CLI
(``python -m iotml.mlops``'s twin).

    python -m iotml_torch.mlops registry --root DIR [--json]
    python -m iotml_torch.mlops list
    python -m iotml_torch.mlops drill ...

``registry`` inspects a registry root (the port's or the JAX
package's): committed versions, channel pointers, promote/rollback
history, printed as the JAX CLI prints them.  The live drills run a
supervised scorer under the JAX package's ``Supervisor``, which is not
ported: ``drill`` raises NotImplementedError naming ROADMAP A14, and
``list`` says so beside each drill.
"""

from __future__ import annotations

import argparse
import json

#: the JAX package's drills and the first line of each one's doc, each
#: not ported yet
DRILLS = {"rollout": "Zero-downtime hot-swap under sustained load.",
          "rollback": "Rollback-on-regression, live: the bad model really "
                      "serves."}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.mlops",
        description="model lifecycle: versioned registry, live "
                    "rollout/rollback drills")
    sub = ap.add_subparsers(dest="cmd")
    dp = sub.add_parser("drill", help="run a live drill (not ported: "
                                      "ROADMAP A14)")
    rp = sub.add_parser("registry", help="inspect a model registry root")
    rp.add_argument("--root", required=True)
    rp.add_argument("--json", action="store_true")
    sub.add_parser("list", help="list available drills")
    # whatever the JAX drill's argv carries is accepted and not read:
    # the subcommand only names the item that ports it
    args, rest = ap.parse_known_args(argv)
    if rest and args.cmd != "drill":
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

    if args.cmd == "list":
        for name, doc in sorted(DRILLS.items()):
            print(f"{name:<10} {doc} (not ported: ROADMAP A14)")
        return 0
    if args.cmd == "registry":
        from .registry import ModelRegistry

        reg = ModelRegistry(args.root)
        desc = reg.describe()
        if args.json:
            print(json.dumps({"registry": desc,
                              "history": reg.history()},
                             indent=2, sort_keys=True))
            return 0
        print(f"registry {desc['root']}")
        for v in desc["versions"]:
            m = reg.manifest(v)
            tags = [c for c in ("serving", "candidate")
                    if desc.get(c) == v]
            off = ", ".join(f"{t}[{p}]={o}" for t, p, o in m.offsets)
            print(f"  v{v:<4} parent={m.parent} step={m.step} "
                  f"offsets({off}) metrics={m.metrics}"
                  + (f"  <- {','.join(tags)}" if tags else ""))
        for e in reg.history()[-8:]:
            print(f"  history: {e}")
        return 0
    if args.cmd != "drill":
        ap.print_help()
        return 2
    raise NotImplementedError(
        "the live mlops drills run under the supervisor, which is not "
        "ported yet (ROADMAP A14)")


if __name__ == "__main__":
    raise SystemExit(main())
