"""registryctl — operator CLI for the kvstore registry (copy of the JAX
package's ``registry/ctl.py``): ``-l`` lists keys and values, ``-f``
flushes the db, ``--get`` prints one key (exit 1 and ``(nil)`` on stderr
when it is missing), ``--set`` writes one. The endpoint comes from the
flags or the TPU_SCHED_REGISTRY_* environment (``config.py``).

Usage:
    python -m k8s_gpu_scheduler_tpu_torch.registry.ctl -l
    python -m k8s_gpu_scheduler_tpu_torch.registry.ctl -f
    python -m k8s_gpu_scheduler_tpu_torch.registry.ctl --get node/v5e-0
"""
from __future__ import annotations

import argparse
import sys

from ..config import SchedulerConfig
from .client import Client


def main(argv=None) -> int:
    cfg = SchedulerConfig.from_env().registry
    ap = argparse.ArgumentParser(prog="registryctl", description=__doc__)
    ap.add_argument("--host", default=cfg.host)
    ap.add_argument("--port", type=int, default=cfg.port)
    ap.add_argument("--password", default=cfg.password)
    ap.add_argument("--db", type=int, default=cfg.db)
    ap.add_argument("-l", "--list", action="store_true", help="list all keys and values")
    ap.add_argument("-f", "--flush", action="store_true", help="flush the db")
    ap.add_argument("--get", metavar="KEY", help="print one key's value")
    ap.add_argument("--set", nargs=2, metavar=("KEY", "VALUE"), help="set a key")
    args = ap.parse_args(argv)

    with Client(args.host, args.port, password=args.password, db=args.db) as c:
        if args.flush:
            c.flush()
            print("OK")
        if args.set:
            c.set(args.set[0], args.set[1])
            print("OK")
        if args.get is not None:
            val = c.get(args.get)
            if val is None:
                print("(nil)", file=sys.stderr)
                return 1
            print(val)
        if args.list:
            for key in sorted(c.get_keys("*")):
                print(f"{key}\t{c.get(key)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
