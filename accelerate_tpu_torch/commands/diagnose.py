"""`diagnose <dir>` — post-mortem report from a run's flight-recorder dumps
and heartbeat files.

Port of ``accelerate_tpu/commands/diagnose.py``, as it stands:
``python -m accelerate_tpu_torch.commands.accelerate_cli diagnose <dir>
[--stall-timeout S] [--json]``; a directory with no dumps and no heartbeats
exits 1.

Point it at the diagnostics dir (``DiagnosticsConfig.dir`` /
``Accelerator(diagnostics="<dir>")``) of a dead or hung job and it names
the rank that stopped first, the last committed checkpoint to restart
from, and where the wall-clock went (goodput/badput breakdown). Works on
a copied directory from any machine — no devices are initialized.
"""

from __future__ import annotations

import argparse
import json
import sys


def diagnose_command(args) -> None:
    from ..diagnostics.diagnose import build_report, format_report

    report = build_report(args.dir, stall_timeout_s=args.stall_timeout)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(format_report(report))
    if report["num_dumps"] == 0 and report["num_heartbeats"] == 0:
        print(
            f"\nNo flight-recorder dumps or heartbeat files under {args.dir}.\n"
            "Enable them with Accelerator(diagnostics='<shared dir>') — every "
            "host must point at the same directory.",
            file=sys.stderr,
        )
        sys.exit(1)


def diagnose_command_parser(subparsers=None) -> argparse.ArgumentParser:
    help_ = "Post-mortem report from flight-recorder dumps + heartbeats"
    if subparsers is not None:
        parser = subparsers.add_parser("diagnose", help=help_)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu diagnose")
    parser.add_argument(
        "dir", help="diagnostics directory (DiagnosticsConfig.dir)"
    )
    parser.add_argument(
        "--stall-timeout",
        type=float,
        default=300.0,
        help="heartbeats older than this many seconds count as stale",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit the raw report as JSON"
    )
    if subparsers is not None:
        parser.set_defaults(func=diagnose_command)
    return parser
