"""Reproducible end-to-end training demo: FE-T learns from scratch.

The counterpart of the repo's scripts/train_demo.py, with its functions,
flags and printed lines, plus `--device`. It builds a small speech corpus
from one bundled recording (`BUNDLED`: the reference repository's
onnx/p232_001-009.wav, 31 s of VCTK speaker p232 at 48 kHz, read from
that relative path under the working directory), trains FastEnhancer_T on
it from scratch through the port's training CLI, and scores the held-out
pair before and after. Everything is seeded. Run it from the repo root:

    python -m fastenhancer_tpu_torch.scripts.train_demo --workdir demo_run \
        [--epochs 300] [--device cuda]

`--recipe shard` drives the whole shard pipeline on the same corpus: the
port's per-corpus builders (shard_speech, shard_noise, shard_dns_rir with
onset/T60 metadata) write shar tars, the shard reader reads them back, and
the DynamicMixer synthesizes each batch (dBFS/SNR/RIR reverb with RTS
dereverberation targets) on the device inside the train step, with
configs/fastenhancer_shard/t.yaml shrunk in schedule only:

    python -m fastenhancer_tpu_torch.scripts.train_demo --workdir demo_shard \
        --recipe shard

Steps:
  1. corpus: slice the bundled 48 kHz wav into 3 s utterances, resample to
     16 kHz, mix each with seeded white + babble-shaped noise at SNR in
     {2.5, 5, 7.5, 10} dB; the last 2 utterances are held out.
  2. train: configs/fastenhancer/t.yaml shrunk in epochs only (the model is
     the real FE_T), in-training PESQ/STOI by the native P.862
     implementation, batch 4; `python -m fastenhancer_tpu_torch.train` in
     a child process.
  3. eval: the noisy input's SISDR/STOI/PESQ on the held-out pair, then
     `python -m fastenhancer_tpu_torch.scripts.metrics_ns` on the trained
     run, also in a child process.

Both children run on the card unless `--device` names another device; a
child that fails ends the demo with its return code. The configs are read
and written by `utils/yaml_subset.py` (no pyyaml).
"""
import argparse
import os
import subprocess
import sys
import typing as tp

import numpy as np

BUNDLED = os.path.join("reference", "onnx", "p232_001-009.wav")
SR = 16000
UTT_SEC = 3.0


def build_corpus(workdir: str, seed: int = 0) -> tp.Dict[str, str]:
    """The paired corpus under {workdir}/corpus; -> {split_kind: dir}."""
    from ..data.audio_io import read_wav, write_wav

    if not os.path.exists(BUNDLED):
        raise FileNotFoundError(
            f"the demo's bundled recording is missing: {BUNDLED}")
    wav, _ = read_wav(BUNDLED, sr=SR)
    n_utt = int(len(wav) // (UTT_SEC * SR))
    rng = np.random.default_rng(seed)
    dirs = {}
    for split in ("train", "test"):
        for kind in ("clean", "noisy"):
            d = os.path.join(workdir, "corpus", split, kind)
            os.makedirs(d, exist_ok=True)
            dirs[f"{split}_{kind}"] = d
    snrs = [2.5, 5.0, 7.5, 10.0]
    for i in range(n_utt):
        clean = wav[int(i * UTT_SEC * SR): int((i + 1) * UTT_SEC * SR)]
        # seeded noise: white + a low-passed (babble-shaped) component
        white = rng.standard_normal(len(clean))
        shaped = np.convolve(rng.standard_normal(len(clean)),
                             np.ones(8) / 8.0, mode="same")
        noise = 0.5 * white + 0.5 * shaped
        snr = snrs[i % len(snrs)]
        noise *= (np.linalg.norm(clean) / max(np.linalg.norm(noise), 1e-9)
                  * 10 ** (-snr / 20))
        split = "test" if i >= n_utt - 2 else "train"
        name = f"p232_{i:03d}.wav"
        write_wav(os.path.join(dirs[f"{split}_clean"], name),
                  clean.astype(np.float32), SR)
        write_wav(os.path.join(dirs[f"{split}_noisy"], name),
                  (clean + noise).astype(np.float32), SR)
    print(f"corpus: {n_utt - 2} train / 2 held-out utterances "
          f"({UTT_SEC:.0f}s each, SNRs {snrs} dB) -> {workdir}/corpus")
    return dirs


def build_shards(workdir: str, dirs: tp.Dict[str, str], seed: int = 0
                 ) -> tp.Dict[str, str]:
    """Run the per-corpus shard builders over seeded synthesized raw
    corpora: speech shards from the demo's train split, noise shards from
    synthesized noise wavs, RIR shards through the DNS-layout CSV adapter
    (onset/T60 metadata feed the mixer's dereverberation targets);
    -> {"speech", "noise", "rir"}: shard dir."""
    from ..data.audio_io import write_wav
    from .data.shard_dns_rir import main as rir_main
    from .data.shard_noise import main as noise_main
    from .data.shard_speech import main as speech_main

    rng = np.random.default_rng(seed + 1)
    shards = os.path.join(workdir, "shards")

    # noise corpus: white / low-passed ("babble") / mains-hum-like tones
    noise_dir = os.path.join(workdir, "noise_corpus")
    os.makedirs(noise_dir, exist_ok=True)
    n = int(10 * SR)
    t = np.arange(n) / SR
    for i in range(8):
        kind = i % 3
        if kind == 0:
            x = rng.standard_normal(n)
        elif kind == 1:
            x = np.convolve(rng.standard_normal(n),
                            np.ones(12) / 12.0, mode="same")
        else:
            f0 = 50.0 * (1 + i)
            x = (np.sin(2 * np.pi * f0 * t)
                 + 0.5 * np.sin(2 * np.pi * 2 * f0 * t)
                 + 0.2 * rng.standard_normal(n))
        x = 0.1 * x / max(np.abs(x).max(), 1e-9)
        write_wav(os.path.join(noise_dir, f"noise_{i:02d}.wav"),
                  x.astype(np.float32), SR)

    # RIR corpus: direct-path peak at a random onset + exponential decay
    # tail with a known T60, through the DNS CSV adapter
    rir_dir = os.path.join(workdir, "rir_corpus")
    os.makedirs(rir_dir, exist_ok=True)
    csv_lines = []
    for i in range(6):
        onset = int(rng.integers(8, 64))
        t60 = float(rng.uniform(0.1, 0.4))
        length = int(0.5 * SR)
        h = np.zeros(length, np.float32)
        tail = rng.standard_normal(length - onset)
        decay = 10.0 ** (-3.0 * np.arange(length - onset) / (SR * t60))
        h[onset:] = 0.3 * tail * decay
        h[onset] = 1.0
        write_wav(os.path.join(rir_dir, f"rir_{i:02d}.wav"), h, SR)
        csv_lines.append(f"rir_{i:02d}.wav,1,{t60:.3f},15.0,{i % 2}")
    csv_path = os.path.join(workdir, "rir_table.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(csv_lines) + "\n")

    speech_main(["-n", "demo-speech", "-d", dirs["train_clean"],
                 "-s", os.path.join(shards, "speech"), "-j", "1", "-f"])
    noise_main(["-n", "demo-noise", "-d", noise_dir,
                "-s", os.path.join(shards, "noise"), "--chunk-sec", "4",
                "--min-sec", "3", "-j", "1", "-f", "--mono"])
    rir_main(["-n", "demo-rir", "--csv", csv_path, "-d", rir_dir,
              "-s", os.path.join(shards, "rir"), "-j", "1", "-f"])
    return {"speech": os.path.join(shards, "speech", "demo-speech"),
            "noise": os.path.join(shards, "noise", "demo-noise"),
            "rir": os.path.join(shards, "rir", "demo-rir")}


def demo_config(recipe: str, epochs: int, seed: int,
                dirs: tp.Dict[str, str],
                shard_dirs: tp.Optional[tp.Dict[str, str]] = None
                ) -> tp.Dict[str, tp.Any]:
    """The recipe's config (read from configs/ under the working
    directory) rewritten for the demo corpus."""
    from ..utils import yaml_subset

    if recipe == "shard":
        with open("configs/fastenhancer_shard/t.yaml") as f:
            cfg = yaml_subset.load(f.read())
        cfg["data"]["train"]["inputs"] = {
            k: [{"shard_dir": v, "weight": 1.0}]
            for k, v in shard_dirs.items()}
        # small pools: the demo corpus has 8 speech / ~16 noise / 6 rir cuts
        cfg["data"]["train"].update({"aux_buffer_size": 64,
                                     "sampler_buffer_size": 64,
                                     "num_workers": 2})
        cfg["data"]["max_duration"] = 48.0   # ~16 x 3 s utterances / batch
        for mode in ("valid", "pesq", "infer"):
            sec = cfg["data"][mode]
            sec["clean_dir"] = dirs["test_clean"]
            sec["noisy_dir"] = dirs["test_noisy"]
        cfg["data"]["infer"]["files"] = []
        cfg["train"].update({"max_epochs": epochs, "steps_per_epoch": 25,
                             "save_interval": epochs, "seed": seed})
        cfg["pesq"]["interval"] = max(epochs // 4, 1)
        cfg["pesq"]["batch_size"] = 2
        cfg["valid"]["batch_size"] = 2
        cfg["infer"]["interval"] = 0
    else:
        with open("configs/fastenhancer/t.yaml") as f:
            cfg = yaml_subset.load(f.read())
        for mode, split in (("train", "train"), ("valid", "test"),
                            ("pesq", "test"), ("infer", "test")):
            sec = cfg["data"][mode]
            sec["clean_dir"] = dirs[f"{split}_clean"]
            sec["noisy_dir"] = dirs[f"{split}_noisy"]
            sec.pop("metadata", None)
        cfg["data"]["infer"]["files"] = []
        cfg["train"].update({"max_epochs": epochs, "batch_size": 4,
                             "num_workers": 2, "save_interval": epochs,
                             "seed": seed})
        cfg["data"]["train"]["segment_size"] = 32000
        # in-training PESQ/STOI every few epochs (native P.862)
        cfg["pesq"]["interval"] = max(epochs // 4, 1)
        cfg["infer"]["interval"] = 0
    return cfg


def main(argv: tp.Optional[tp.Sequence[str]] = None
         ) -> tp.Dict[str, float]:
    """Builds the corpus, trains and scores; returns the noisy baseline's
    means ({"sisdr", "stoi", "pesq"}). A child that fails ends the process
    with its return code (SystemExit)."""
    from ..utils.precision import full_float32

    full_float32()
    ap = argparse.ArgumentParser(
        prog="python -m fastenhancer_tpu_torch.scripts.train_demo")
    ap.add_argument("--workdir", default="demo_run")
    ap.add_argument("--epochs", type=int, default=None,
                    help="default 300 (paired) / 40 (shard; x25 steps each)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recipe", choices=("paired", "shard"), default="paired",
                    help="paired: configs/fastenhancer/t.yaml on the paired "
                         "corpus; shard: configs/fastenhancer_shard/t.yaml "
                         "through the full shard pipeline (builders -> tar "
                         "reader -> device DynamicMixer)")
    ap.add_argument("--device", default=None,
                    help="torch device of both children (default: the "
                         "first CUDA card; they raise when there is none)")
    args = ap.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]

    from ..utils import yaml_subset

    dirs = build_corpus(args.workdir, args.seed)
    if args.recipe == "shard":
        epochs = args.epochs or 40
        cfg = demo_config("shard", epochs, args.seed, dirs,
                          build_shards(args.workdir, dirs, args.seed))
    else:
        epochs = args.epochs or 300
        cfg = demo_config("paired", epochs, args.seed, dirs)
    cfg_path = os.path.join(args.workdir, "demo.yaml")
    with open(cfg_path, "w") as f:
        f.write(yaml_subset.dump(cfg))

    logs = os.path.join(args.workdir, "logs")
    run = subprocess.run(
        [sys.executable, "-m", "fastenhancer_tpu_torch.train", "-n", "demo",
         "-c", cfg_path, "--base_dir", logs, "-f", *device],
        env=dict(os.environ))
    if run.returncode != 0:
        sys.exit(run.returncode)

    # score held-out: noisy baseline, then the trained model
    from ..data.audio_io import read_wav
    from ..metrics import pesq_wb, sisdr, stoi

    base = {"sisdr": [], "stoi": [], "pesq": []}
    for f in sorted(os.listdir(dirs["test_clean"])):
        c, _ = read_wav(os.path.join(dirs["test_clean"], f))
        n, _ = read_wav(os.path.join(dirs["test_noisy"], f))
        base["sisdr"].append(sisdr(n, c))
        base["stoi"].append(stoi(c, n, SR))
        base["pesq"].append(pesq_wb(c, n, SR))
    print(f"noisy baseline: SISDR {np.mean(base['sisdr']):.2f} dB, "
          f"STOI {np.mean(base['stoi']):.3f}, "
          f"PESQ {np.mean(base['pesq']):.2f}")
    run = subprocess.run(
        [sys.executable, "-m", "fastenhancer_tpu_torch.scripts.metrics_ns",
         "-n", "demo", "--base_dir", logs, *device], env=dict(os.environ))
    if run.returncode != 0:
        sys.exit(run.returncode)
    return {k: float(np.mean(v)) for k, v in base.items()}


if __name__ == "__main__":
    main()
