"""What full float32 costs the port's float32 train steps on a CUDA card,
and whether FE-L's bf16 train step stays bit-equal run to run under
PyTorch's deterministic algorithms.

    python tools/train_step_precision.py [--out FILE]

1. TF32: the float32 train steps of configs/others/{bsrnn_s,fspen,
   lisennet}.yaml and configs/fastenhancer/b.yaml (`train.fp16=False`) at
   the recipes' 64 x 2 s, each from the recipe's initial state, with TF32
   on and off for products and convolutions. ROUNDS rounds, each a block
   of STEPS timed steps a setting after one untimed step, the order of the
   settings reversed every second round: each setting's median and
   quartiles, and whether the two quartile ranges are apart.
2. Determinism: in a fresh process with CUBLAS_WORKSPACE_CONFIG=:4096:8,
   `torch.use_deterministic_algorithms(True, warn_only=True)` and
   `cudnn.deterministic`, FE-L's bf16 step (configs/fastenhancer/l.yaml,
   16 x 2 s) twice from one state, without and with `train.remat`: how
   many gradient leaves differ, and each op that PyTorch warns has no
   deterministic CUDA form.

Prints one line a measurement with the card's name and power limit, and
writes all of them as JSON to --out. Runs on a CUDA card only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SR = 16_000
ROWS, SECONDS = 64, 2.0
ROUNDS, STEPS = 4, 3
TIMED = [("others/bsrnn_s.yaml", []), ("others/fspen.yaml", []),
         ("others/lisennet.yaml", []),
         ("fastenhancer/b.yaml", ["train.fp16=False"])]
DET_CONFIG, DET_ROWS = "fastenhancer/l.yaml", 16


def speech_batch(rows: int, device: torch.device) -> dict:
    """Noise under a 3 Hz envelope with a silent sixth, and that plus white
    noise as the noisy input (chip_smoke.py's speech-like signal)."""
    rng = np.random.default_rng(24)
    n = int(SECONDS * SR)
    t = np.arange(n) / SR
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t
                             + rng.uniform(0, 2 * np.pi, (rows, 1)))
    clean = rng.standard_normal((rows, n)) * 0.1 * env
    clean[:, n // 3: n // 2] = 0.0
    noisy = clean + rng.standard_normal(clean.shape) * 0.05
    return {"clean": torch.from_numpy(clean.astype(np.float32)).to(device),
            "noisy": torch.from_numpy(noisy.astype(np.float32)).to(device),
            "row_mask": torch.ones(rows, device=device)}


class Stepper:
    """One recipe's train step from a copy of its initial variables (a new
    optimizer each call) -> (gradients by leaf path, ms, loss)."""

    def __init__(self, config: str, overrides, rows: int):
        from fastenhancer_tpu_torch.utils.hparams import HParams, get_hparams
        from fastenhancer_tpu_torch.wrappers import get_wrapper

        hps = get_hparams(os.path.join(REPO, "configs", config),
                          params=list(overrides)).to_dict()
        hps["wrapper"] = "ns"      # paired batches, no files read
        hps.pop("pesq", None)
        self.hps = HParams(**hps)
        self.w = get_wrapper("ns")(self.hps, train=True,
                                   device=torch.device("cuda"))
        self.batch = speech_batch(rows, self.w.device)
        self.dtype = "bf16" if self.w.compute_dtype else "float32"

    def __call__(self, remat=None):
        from fastenhancer_tpu_torch.optim import get_optimizer
        from fastenhancer_tpu_torch.train import make_train_step
        from fastenhancer_tpu_torch.utils import tree_map, tree_paths

        w = self.w
        if remat is not None:
            w.model.remat = remat
        v = tree_map(lambda a: a.clone(), w.state["variables"])
        opt = get_optimizer(w.model, v["params"], self.hps["train"])
        step = make_train_step(w.model, w.loss, opt,
                               compute_dtype=w.compute_dtype,
                               return_grads=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step({"variables": v}, self.batch, [1e-3] * opt.n_groups)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        grads = {"/".join(map(str, p)): g for p, g in tree_paths(m["grads"])}
        return grads, ms, float(m["loss/total"])


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def tf32_cost(card: str) -> list:
    results = []
    for config, overrides in TIMED:
        stepper = Stepper(config, overrides, ROWS)
        ms = {"TF32 on": [], "TF32 off": []}
        for r in range(ROUNDS):
            for name in (list(ms) if r % 2 == 0 else list(ms)[::-1]):
                set_tf32(name == "TF32 on")
                stepper()  # untimed: the setting's first step
                ms[name] += [stepper()[1] for _ in range(STEPS)]
        q = {k: [float(np.percentile(v, p)) for p in (25, 50, 75)]
             for k, v in ms.items()}
        on, off = q["TF32 on"], q["TF32 off"]
        apart = on[2] < off[0] or off[2] < on[0]
        results.append(dict(config=config, overrides=overrides, rows=ROWS,
                            seconds=SECONDS, dtype=stepper.dtype, ms=ms,
                            quartiles=q, apart=apart))
        print(f"[tf32] {config} {' '.join(overrides)} ({stepper.dtype}, "
              f"{ROWS} x {SECONDS:g} s), step ms quartiles (25/50/75) over "
              f"{len(ms['TF32 on'])} steps a setting: TF32 on "
              f"{[round(x, 1) for x in on]}, off {[round(x, 1) for x in off]}"
              f"; off / on median {off[1] / on[1]:.3f}; quartile ranges "
              f"{'apart' if apart else 'overlap'}; on [{card}]", flush=True)
        del stepper
        torch.cuda.empty_cache()
    set_tf32(False)
    return results


def determinism_child() -> dict:
    """FE-L's bf16 step twice a setting of remat, under the deterministic
    settings, in this (fresh) process."""
    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    stepper = Stepper(DET_CONFIG, [], DET_ROWS)
    out = {"cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
           "remat": {}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for remat in (False, True):
            (g1, ms1, l1), (g2, ms2, l2) = stepper(remat), stepper(remat)
            out["remat"][str(remat)] = dict(
                differ=[p for p, a in g1.items() if not torch.equal(a, g2[p])],
                leaves=len(g1), loss_equal=l1 == l2, ms=[ms1, ms2])
            del g1, g2
    ops = []
    for w in caught:
        line = str(w.message).strip().splitlines()[0]
        if "deterministic" in line and line not in ops:
            ops.append(line)
    out["warned"] = ops
    return out


def determinism(card: str, out_path: str) -> dict:
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child_out = out_path + ".child.json"
    subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                    "--out", child_out], cwd=REPO, env=env, check=True,
                   timeout=1200)
    with open(child_out) as f:
        res = json.load(f)
    os.remove(child_out)
    for remat, r in res["remat"].items():
        print(f"[determinism] {DET_CONFIG} (bf16, {DET_ROWS} x {SECONDS:g} s)"
              f", remat {remat}, use_deterministic_algorithms + "
              f"cudnn.deterministic, CUBLAS_WORKSPACE_CONFIG "
              f"{res['cublas_workspace']}: {len(r['differ'])} of "
              f"{r['leaves']} gradient leaves differ between two steps from "
              f"one state {r['differ'][:4]}, loss equal {r['loss_equal']}, "
              f"step ms {[round(x, 1) for x in r['ms']]}; on [{card}]")
    for msg in res["warned"]:
        print(f"[determinism] warned: {msg}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(prog="tools/train_step_precision.py")
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "train_step_precision.json"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_precision: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        with open(args.out, "w") as f:
            json.dump(determinism_child(), f)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(f"{card} | torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = {"card": card, "determinism": determinism(card, args.out),
           "tf32": tf32_cost(card)}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
