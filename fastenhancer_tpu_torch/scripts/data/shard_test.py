"""Synthesize a fixed evaluation set into shar shards.

The port's scripts/data/shard_test.py (reference: scripts/data/
shard_test.py:40-322): every near-end speech file becomes one cut whose
degradation recipe is sampled ONCE and frozen into the shard — noise
(parallel `noise` tar, SNR drawn from range(lo, hi+1, step) in the
supervision), optional near-end RIR (float32 `rir` tar + rir_t60/
rir_onset custom, `return_rir` drawn against nearend.rir.prob), optional
AEC farend/echo pair (parallel `farend`/`echo` tars, SER/farend_type/
return_farend in the supervision; no SER when the echo branch isn't
selected). Speech dbFS targets are drawn per cut from
nearend.speech_dbFS. The per-cut supervision custom payload reaches
consumers as Cut.sup (data/shard.py).

Every draw of cut `idx` comes from one `random.Random(seed * 1_000_003 +
idx)`, in the order the JAX package's copy draws from the module-level
`random` it reseeds so: for the same `--seed` both write the same tars,
whatever `-j` is.

Deviations from the reference: the farend section is optional (the
reference constructs its Farend sampler unconditionally and crashes
without AEC corpora); RIRs are stored as IEEE-float32 wav members instead
of lhotse numpy arrays (same lossless payload, readable by the reader's
tar walker).

    python -m fastenhancer_tpu_torch.scripts.data.shard_test -n vctk-test \
        -c configs/shard_test/se_test.yaml -s SHARD_ROOT [-j 8] [-f] \
        [--seed 1234]
"""
import argparse
import os
import random

import numpy as np

_STATE: dict = {}


def _init_worker(config_path: str, seed: int):
    """Build the per-worker samplers (reference :67-110); a spawned worker
    runs it once, `-j 1` once in-process. The reference seeds workers from
    the pid, which makes the 'frozen' set different on every invocation;
    here every cut draws from its own generator keyed by (seed, cut
    index), so `--seed S` regenerates the exact same shards regardless of
    job count or OS scheduling."""
    from ...utils.hparams import get_hparams

    from .corpus_utils import DirectoriesDataset, Farend, ReverbDataset

    _STATE["seed"] = seed

    hps = get_hparams(config_path)
    snr_lo, snr_hi, snr_step = hps["nearend"]["noise"]["snr"]
    _STATE.update(
        fs=hps["fs"],
        thr_rel=hps.get("activity_threshold_relative"),
        thr_abs=hps.get("activity_threshold_absolute"),
        data_dir=hps["input"]["nearend_speech"]["base_dir"],
        nearend_snr=list(range(snr_lo, snr_hi + 1, snr_step)),
        nearend_speech_dbFS=list(hps["nearend"]["speech_dbFS"]),
        rir_prob=(hps["nearend"]["rir"]["prob"]
                  if "rir" in hps["nearend"] else 0.0),
        noise=None, rir=None, farend=None)
    if "nearend_noise" in hps["input"]:
        _STATE["noise"] = DirectoriesDataset(
            directories=hps["input"]["nearend_noise"],
            fs=hps["fs"],
            silence_length=hps["silence_length"],
            activity_threshold_relative=_STATE["thr_rel"],
            normalize_output=False)
    if "rir" in hps.get("nearend", {}):
        _STATE["rir"] = ReverbDataset(hps["fs"], hps["input"]["rir"])
    if "farend" in hps["input"]:
        _STATE["farend"] = Farend(hps)


def _active_rms(x, fs):
    from ..audiolib import active_rms_relative

    kw = {}
    if _STATE["thr_rel"] is not None:
        kw["relative_threshold_db"] = _STATE["thr_rel"]
    if _STATE["thr_abs"] is not None:
        kw["absolute_threshold_db"] = _STATE["thr_abs"]
    return active_rms_relative(x, fs, **kw)


def process_single_line(job):
    idx, path = job
    from ...data.audio_io import read_audio

    from .corpus_utils import match_length

    # every degradation draw for cut `idx` comes from a stream keyed by
    # (base seed, idx), so the frozen set is identical whichever worker
    # (or how many) processes it
    rng = random.Random(_STATE["seed"] * 1_000_003 + idx)

    fs = _STATE["fs"]
    try:
        speech, _ = read_audio(os.path.join(_STATE["data_dir"], path),
                               sr=fs)
    except Exception as e:
        return f"Error processing {path}: {e}"
    duration = len(speech) / fs
    cut = {"id": str(idx), "audio": speech.astype(np.float32), "sr": fs,
           "custom": {"rms": float(_active_rms(speech, fs))},
           "sup": {"dbFS": rng.uniform(*_STATE["nearend_speech_dbFS"])},
           "extras": {}}

    if _STATE["rir"] is not None:
        rir, t60, onset = _STATE["rir"](rng)
        cut["extras"]["rir"] = rir
        cut["custom"]["rir_t60"] = t60
        cut["custom"]["rir_onset"] = onset
        cut["sup"]["return_rir"] = rng.random() < _STATE["rir_prob"]

    if _STATE["noise"] is not None:
        noise, _ = _STATE["noise"](duration, rng)
        noise = match_length(noise, len(speech))
        cut["extras"]["noise"] = noise.astype(np.float32)
        cut["custom"]["rms_noise"] = float(_active_rms(noise, fs))
        cut["sup"]["snr"] = rng.choice(_STATE["nearend_snr"])

    if _STATE["farend"] is not None:
        farend, echo, ser, ftype, f_exists, e_exists = \
            _STATE["farend"](duration, rng)
        cut["extras"]["farend"] = match_length(
            farend, len(speech)).astype(np.float32)
        echo = match_length(echo, len(speech)).astype(np.float32)
        cut["extras"]["echo"] = echo
        cut["custom"]["rms_echo"] = float(_active_rms(echo, fs))
        cut["sup"]["farend_type"] = ftype
        cut["sup"]["return_farend"] = f_exists
        # the reference stores inf when echo is absent (its
        # scripts/data/shard_test.py:190), but inf is not representable in
        # strict JSON — omit the key instead; readers treat a missing ser
        # as "no echo"
        if e_exists:
            cut["sup"]["ser"] = ser
    return [cut]


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-n", "--name", default="vctk-test")
    ap.add_argument("-s", "--shar-dir", default="data/shards/test")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-f", "--force", action="store_true")
    ap.add_argument("-j", "--num-jobs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed; the same seed regenerates the same "
                         "shards (every cut reseeds from seed + index)")
    ap.add_argument("--shard-size", type=int, default=1000)
    ap.add_argument("--debug", action="store_true",
                    help="process only 100 files with one worker")
    args = ap.parse_args(argv)

    from ...utils.hparams import get_hparams

    hps = get_hparams(args.config)
    data_dir = hps["input"]["nearend_speech"]["base_dir"]
    ext = hps["input"]["nearend_speech"]["extension"]
    files = []
    for r, _, names in os.walk(data_dir, followlinks=True):
        for n2 in names:
            if n2.endswith(ext):
                files.append(os.path.relpath(os.path.join(r, n2), data_dir))
    files.sort()
    if args.debug:
        args.num_jobs = 1
        files = files[:100]
    fields = ["recording"]
    if "rir" in hps.get("nearend", {}):
        fields.append("rir")
    if "nearend_noise" in hps["input"]:
        fields.append("noise")
    if "farend" in hps["input"]:
        fields += ["farend", "echo"]
    print(f"Total files: {len(files)}; fields: {fields}")
    from .shar_writer import run_adapter

    run_adapter(
        list(enumerate(files)), process_single_line,
        args.shar_dir, args.name, shard_size=args.shard_size,
        num_jobs=args.num_jobs, force=args.force, fields=fields,
        initializer=_init_worker, initargs=(args.config, args.seed))


if __name__ == "__main__":
    main()
