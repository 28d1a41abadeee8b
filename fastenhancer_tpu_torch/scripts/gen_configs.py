"""Regenerate configs/**.yaml from the port's config builder, without
pyyaml.

The port's scripts/gen_configs.py: the same flags, header and bytes. The
text is `utils/yaml_subset.py::dump`, which writes what
`yaml.dump(cfg, sort_keys=False, indent=4, default_flow_style=None)`
writes.

    python -m fastenhancer_tpu_torch.scripts.gen_configs [--check] [--out DIR]

--check verifies the files on disk match the builder output (CI guard).
"""
import argparse
import os
import sys
import typing as tp

from ..configs import build_all
from ..utils import yaml_subset

HEADER = ("# generated by scripts/gen_configs.py — edit the builder, not "
          "this file\n")


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default="configs")
    args = ap.parse_args(argv)

    ok = True
    for rel, cfg in build_all().items():
        path = os.path.join(args.out, rel + ".yaml")
        text = HEADER + yaml_subset.dump(cfg)
        if args.check:
            if not os.path.exists(path):
                print(f"STALE: {path}")
                ok = False
                continue
            with open(path, encoding="utf-8") as f:
                if f.read() != text:
                    print(f"STALE: {path}")
                    ok = False
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {path}")
    if args.check and not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
