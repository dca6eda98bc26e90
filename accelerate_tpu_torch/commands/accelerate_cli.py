"""The port's command line: ``python -m accelerate_tpu_torch.commands.accelerate_cli
<command>``.

Port of ``accelerate_tpu/commands/accelerate_cli.py`` with the ``diagnose``
subcommand; the others wait for ROADMAP.md, queue A10.
"""

from __future__ import annotations

import argparse
import sys

from .diagnose import diagnose_command_parser


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "accelerate-tpu",
        usage="accelerate-tpu <command> [<args>]",
        allow_abbrev=False,
    )
    subparsers = parser.add_subparsers(dest="command")
    diagnose_command_parser(subparsers)

    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        sys.exit(1)
    args.func(args)


if __name__ == "__main__":
    main()
