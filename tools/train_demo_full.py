"""The training demo at its full schedule on a stand-in of its recording.

    python tools/train_demo_full.py [--out FILE] [--epochs N]

Writes chip_smoke.py's seeded 31 s stand-in of the demo's bundled 48 kHz
recording (`chip_smoke.standin_recording`), points
`fastenhancer_tpu_torch.scripts.train_demo.BUNDLED` at it and runs the
demo's `main` for the paired and the shard recipe at their default
epochs (300 and 40; `--epochs` for both otherwise), with its two
children run through chip_smoke's counting shim (`chip_smoke.demo_run`). Prints one line a
recipe, with the card's name and power limit: the demo's wall and each
child's, the training child's mix+step ms a step, the held-out pair's
SISDR, STOI and PESQ of the noisy input and of the trained model, and each
child's kernel launches. Writes them as JSON to --out. Runs on the first
CUDA card, from the repo root.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--epochs", type=int, default=None,
                    help="both recipes' epochs (default: the demo's own)")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import chip_smoke
    from fastenhancer_tpu_torch import require_cuda
    from fastenhancer_tpu_torch.ops import _build
    from fastenhancer_tpu_torch.scripts import train_demo

    dev = require_cuda()
    _build.build_all(_build.SOURCES)   # here, so no child times a build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    tmp = tempfile.mkdtemp(prefix="train_demo_full_")
    results = []
    try:
        train_demo.BUNDLED = chip_smoke.standin_recording(
            os.path.join(tmp, "p232.wav"))
        for recipe in ("paired", "shard"):
            work = os.path.join(tmp, recipe)
            os.makedirs(work)
            argv = ["--workdir", work, "--recipe", recipe,
                    "--device", str(dev)]
            if args.epochs:
                argv += ["--epochs", str(args.epochs)]
            r = chip_smoke.demo_run(argv, work)
            sc = chip_smoke.demo_scores(r)
            row = dict(recipe=recipe, epochs=args.epochs, rc=r["rc"],
                       seconds=r["seconds"], card=smi,
                       baseline=r["baseline"], **sc,
                       children=[{k: c[k] for k in ("module", "rc",
                                                    "seconds", "counts")}
                                 for c in r["children"]])
            results.append(row)
            print(json.dumps(row), flush=True)
            for c in r["children"]:
                if c["rc"]:
                    print(c["stdout"][-3000:], c["stderr"][-3000:])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
