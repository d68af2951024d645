"""Delete a run's checkpoints, data and logs:
``python -m alphazero_general_tpu_torch.cli.clean <run_name>`` — the port of
alphazero_general_tpu/cli/clean.py (reference: remove_train.py:1-13), with
a confirmation prompt the reference lacks.
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_name")
    p.add_argument("--checkpoint", default="checkpoint")
    p.add_argument("--data", default="data")
    p.add_argument("--runs", default="runs")
    p.add_argument("--yes", action="store_true", help="skip confirmation")
    ns = p.parse_args(argv)

    targets = [os.path.join(root, ns.run_name)
               for root in (ns.checkpoint, ns.data, ns.runs)]
    existing = [t for t in targets if os.path.exists(t)]
    if not existing:
        print(f"nothing to remove for run {ns.run_name!r}")
        return 0
    print("will remove:")
    for t in existing:
        print(f"  {t}")
    if not ns.yes and input("proceed? [y/N] ").strip().lower() != "y":
        print("aborted")
        return 1
    for t in existing:
        shutil.rmtree(t)
        print(f"removed {t}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
