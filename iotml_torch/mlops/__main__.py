"""``python -m iotml_torch.mlops`` — the model-lifecycle CLI
(``python -m iotml.mlops``'s twin).

    python -m iotml_torch.mlops drill [--drill rollout|rollback | --all]
                                      [--seed S] [--records N] [--json]
                                      [--slo-swap S] [--slo-rollback S]
    python -m iotml_torch.mlops registry --root DIR [--json]
    python -m iotml_torch.mlops list

``drill`` runs a live drill (real threads, a supervised scorer, a
registry watcher hot-swapping under load) and exits with the invariant
verdict (0: zero records lost or double-scored across every swap, SLOs
met).  ``registry`` inspects a registry root (the port's or the JAX
package's): committed versions, channel pointers, promote/rollback
history, printed as the JAX CLI prints them.  ``main(argv,
device=...)`` runs the drills' scorers and trainers on ``device``
(``cuda`` unless given).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.device import DeviceLike


def main(argv=None, device: DeviceLike = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.mlops",
        description="model lifecycle: versioned registry, live "
                    "rollout/rollback drills")
    sub = ap.add_subparsers(dest="cmd")
    dp = sub.add_parser("drill", help="run a live drill; exit status is "
                                      "the invariant verdict")
    dp.add_argument("--drill", default="rollout",
                    help="drill name (see `list`)")
    dp.add_argument("--all", action="store_true",
                    help="run every drill in sequence")
    dp.add_argument("--seed", type=int, default=7)
    dp.add_argument("--records", type=int, default=0,
                    help="records to pump (0 = the drill's default)")
    dp.add_argument("--slo-swap", type=float, default=5.0,
                    help="rollout: max seconds promote -> scorer swap")
    dp.add_argument("--slo-rollback", type=float, default=60.0,
                    help="rollback: max seconds deploy -> rollback "
                         "verdict")
    dp.add_argument("--json", action="store_true")
    rp = sub.add_parser("registry", help="inspect a model registry root")
    rp.add_argument("--root", required=True)
    rp.add_argument("--json", action="store_true")
    sub.add_parser("list", help="list available drills")
    args = ap.parse_args(argv)

    from .drill import DRILLS

    if args.cmd == "list":
        for name, fn in sorted(DRILLS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:<10} {doc}")
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

    names = sorted(DRILLS) if args.all else [args.drill]
    unknown = [n for n in names if n not in DRILLS]
    if unknown:
        print(f"unknown drill(s) {unknown}; have: {sorted(DRILLS)}",
              file=sys.stderr)
        return 2
    ok = True
    for name in names:
        kw = {"seed": args.seed, "device": device}
        if args.records:
            kw["records"] = args.records
        if name == "rollout":
            kw["slo_swap_s"] = args.slo_swap
        elif name == "rollback":
            kw["slo_rollback_s"] = args.slo_rollback
        report = DRILLS[name](**kw)
        if args.json:
            print(json.dumps(report.to_dict(), indent=2, sort_keys=True,
                             default=str))
        else:
            print("\n".join(report.lines()))
        ok = ok and report.ok
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
