"""Shared CLI plumbing — the port of alphazero_general_tpu/cli/common.py."""

from __future__ import annotations

import argparse
import ast

from alphazero_general_tpu_torch.envs import list_envs
from alphazero_general_tpu_torch.envs.presets import preset_args
from alphazero_general_tpu_torch.utils.config import (
    Args, get_args, load_args_file,
)


def add_env_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("env", help=f"environment name ({', '.join(list_envs())})")


def add_args_overrides(p: argparse.ArgumentParser) -> None:
    p.add_argument("--args-file", help="JSON args file (save_args_file "
                   "format; either package's)")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override an arg, e.g. --set numMCTSSims=50 (repeatable; values "
             "parsed as Python literals, falling back to string)")


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the networks, trees and games live (default "
                        "cuda; cpu runs every kernel's plain version)")


def resolve_args(ns: argparse.Namespace) -> Args:
    """The env's preset (or an args file) with the ``--set`` overrides."""
    if ns.args_file:
        args = get_args(load_args_file(ns.args_file))
    else:
        args = preset_args(ns.env)
    for item in ns.set:
        key, sep, raw = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        args[key] = value
    return args
