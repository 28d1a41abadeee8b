"""Checkpoint GC: keep the last N checkpoints per run directory.

The port's scripts/clean_checkpoint.py (reference:
scripts/clean_checkpoint.py:45-91): walk a logs tree, keep the newest
`--keep` NNNNN.ckpt per directory, print the tree of removals.

    python -m fastenhancer_tpu_torch.scripts.clean_checkpoint [logs] \
        [--keep 1] [--dry-run]
"""
import argparse
import os
import typing as tp

from ..train.checkpoint import _CKPT_RE, clean_checkpoints


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default="logs")
    ap.add_argument("--keep", type=int, default=1)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    for dirpath, _, files in sorted(os.walk(args.root)):
        ckpts = sorted(f for f in files if _CKPT_RE.match(f))
        if not ckpts:
            continue
        doomed = ckpts[: -args.keep] if args.keep else ckpts
        keep = ckpts[-args.keep:] if args.keep else []
        print(f"{dirpath}: keep {keep}, remove {len(doomed)}")
        if not args.dry_run and doomed:
            removed = clean_checkpoints(dirpath, keep_last=args.keep)
            for path in removed:
                print(f"  removed {path}")


if __name__ == "__main__":
    main()
