"""Config introspection CLI.

    PYTHONPATH=src python -m repro_torch.api --print-config [--mode MODE]

Dumps the (default) `OffloadConfig` as sorted JSON, with the mode's
resolved insertion options and the effective tier chain. It equals the
JAX package's ``CONFIG_default.json`` in every key but ``hw`` (the port
plans under ``h100_sxm``).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.api.config import MODES, OffloadConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="HyperOffload public-API introspection (PyTorch port)")
    ap.add_argument("--print-config", action="store_true",
                    help="dump the default OffloadConfig as JSON")
    ap.add_argument("--mode", choices=MODES, default=None,
                    help="dump the defaults for this mode instead")
    args = ap.parse_args(argv)
    if not args.print_config:
        ap.print_help()
        return 2
    cfg = OffloadConfig() if args.mode is None else OffloadConfig(mode=args.mode)
    d = cfg.to_dict()
    # the effective (mode-resolved) planner default is part of the surface
    d["insertion_resolved"] = cfg.insertion_options().__dict__
    # likewise the effective tier chain (explicit topology, or the default
    # three-tier chain built from the capacity fields)
    d["topology_resolved"] = cfg.tier_topology.to_dict()
    print(json.dumps(d, indent=2, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
