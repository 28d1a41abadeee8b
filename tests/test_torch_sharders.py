"""The port's shard builders (fastenhancer_tpu_torch/scripts/data/) against
the JAX package's (scripts/data/), on one seeded synthetic corpus.

Each builder's `main(argv)` runs in-process on both sides into separate
directories (the port's `-j 2` case in spawned workers). Equal means: the
decompressed cut lists (gzip stamps the time into a `.gz` header), the
tar bytes and the `.done` text are equal, and what each side's
ShardSource reads back is equal."""
import gzip
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from fastenhancer_tpu.data.shard import ShardSource as JaxShardSource
from fastenhancer_tpu_torch.data.audio_io import write_wav
from fastenhancer_tpu_torch.data.shard import ShardSource
from fastenhancer_tpu_torch.utils import yaml_subset

from _torch_parity import deadline, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SR = 16000
POOL_TIMEOUT = 240  # seconds for a tool's run with its spawned pool


def _tone(rng, seconds, sr=SR, amp=0.2):
    t = np.arange(int(seconds * sr)) / sr
    x = amp * np.sin(2 * np.pi * rng.uniform(150, 600) * t)
    return (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _rir(rng, seconds=0.25, onset=32):
    n = int(seconds * SR)
    r = rng.standard_normal(n) * np.exp(-np.arange(n) / (0.05 * SR)) * 0.3
    r[:onset] = 0.0
    r[onset] = 0.9
    return r.astype(np.float32)


def write_corpus(root):
    """Every raw layout the builders walk, small: speech (one file at
    22.05 kHz, one too short, one silent), noise (stereo with a silent
    channel, mono, 3 channels), DNS-style RIRs and CSVs, a long recording
    with silent stretches, VCTK speakers, DEMAND scenes, BRUDEX and MYRiAD
    RIR trees, and the AEC farend/echo pairs. -> {name: path}."""
    rng = np.random.default_rng(20)
    d = {k: root / k for k in ("speech", "noise", "rirs", "long", "vctk",
                               "demand", "brudex", "myriad", "aec")}

    def put(path, x, sr=SR):
        path.parent.mkdir(parents=True, exist_ok=True)
        write_wav(str(path), x, sr)

    put(d["speech"] / "a.wav", _tone(rng, 1.0))
    put(d["speech"] / "sub" / "b.wav", _tone(rng, 1.5, 22050), 22050)
    put(d["speech"] / "c.wav", _tone(rng, 1.2))
    put(d["speech"] / "short.wav", _tone(rng, 0.2))
    put(d["speech"] / "silent.wav", np.zeros(SR, np.float32))
    stereo = np.stack([_tone(rng, 2.5), np.zeros(int(2.5 * SR), "f4")], 1)
    put(d["noise"] / "n0.wav", stereo)
    put(d["noise"] / "n1.wav", 0.1 * rng.standard_normal(
        int(2.2 * SR)).astype(np.float32))
    put(d["noise"] / "n2.wav", (0.1 * rng.standard_normal(
        (int(2.1 * SR), 3))).astype(np.float32))
    put(d["rirs"] / "r0.wav", _rir(rng))
    put(d["rirs"] / "sub" / "r1.wav", np.stack([_rir(rng, onset=10),
                                                 _rir(rng, onset=50)], 1))
    (root / "dns_rir.csv").write_text(
        "path,channel,t60,c50,is_real\nr0.wav,1,0.3,10.0,1\n"
        "sub\\r1.wav,2,0.5,5.0,0\nr0.wav,2,0.3,1.0,1\n"
        "missing.wav,1,0.3,1.0,0\n")
    (root / "rir_test.csv").write_text(
        "path,channel,t60\nr0.wav,1,0.3\nsub/r1.wav,2,0.5\nsub/r1.wav,1,0.4\n")
    gap = np.zeros(int(0.8 * SR), np.float32)
    put(d["long"] / "rec.wav", np.concatenate([
        gap, _tone(rng, 1.5), gap, _tone(rng, 2.0), gap, _tone(rng, 0.3)]))
    for spk in ("p001", "p232", "p257", "p300"):
        put(d["vctk"] / spk / f"{spk}_001.wav", _tone(rng, 0.8))
    put(d["vctk"] / "stray.wav", _tone(rng, 0.8))
    for scene in ("DKITCHEN_16k", "SCAFE", "TMETRO"):
        put(d["demand"] / scene / "ch01.wav", _tone(rng, 2.3))
    put(d["brudex"] / "rev_low" / "a.wav", np.stack(
        [_rir(rng, 0.2, o) for o in (5, 9, 14)], 1))
    put(d["brudex"] / "rev_high" / "b.wav", np.stack(
        [_rir(rng, 0.3, o) for o in (20, 25)], 1))
    put(d["myriad"] / "SAL" / "P1" / "x.wav", np.stack(
        [_rir(rng, 0.2, 7), _rir(rng, 0.2, 8)], 1))
    put(d["myriad"] / "AIL" / "P2" / "y.wav", _rir(rng, 0.2, 30))
    for i in range(2):
        put(d["aec"] / "farend_speech" / f"farend_speech_fileid_{i}.wav",
            _tone(rng, 1.5, amp=0.25))
        put(d["aec"] / "echo_signal" / f"echo_fileid_{i}.wav",
            _tone(rng, 1.5, amp=0.1))
        put(d["aec"] / "real" / f"f{i}.wav", _tone(rng, 1.1, amp=0.25))
        put(d["aec"] / "real" / f"e{i}.wav", _tone(rng, 1.1, amp=0.05))
    (root / "real.tsv").write_text("farend\techo\tncc\n"
                                   "real/f0.wav\treal/e0.wav\t0.9\n"
                                   "real/f1.wav\treal/e1.wav\t0.2\n")
    return {k: str(v) for k, v in d.items()}


def make_testset_config(root, corpus, farend):
    """A shard_test config written by the port's YAML writer: noise from
    two pools (one mixing the other in) and RIRs, or the AEC farend."""
    cfg = {
        "fs": SR, "silence_length": 0.1,
        "activity_threshold_relative": -25.0,
        "activity_threshold_absolute": -50.0,
        "input": {"nearend_speech": {"base_dir": corpus["speech"],
                                     "extension": ".wav"}},
        "nearend": {"speech_dbFS": [-30.0, -15.0],
                    "noise": {"snr": [-5, 15, 5]}},
    }
    if farend:
        cfg["input"]["farend"] = {
            "aec_challenge_real": [{"base_dir": corpus["aec"],
                                    "tsv": str(root / "real.tsv")}],
            "aec_challenge_synthetic": {"base_dir": corpus["aec"],
                                        "id": {"lower": 0, "upper": 1}}}
        cfg["farend"] = {
            "prob": {"farend_echo": 0.5, "farend_only": 0.3},
            "aec_challenge_real": {"ser": [-10, 10, 5],
                                   "ncc_threshold": 0.5, "prob": 0.5},
            "aec_challenge_synthetic": {"ser": [-10, 10, 5], "prob": 0.5}}
    else:
        cfg["input"]["nearend_noise"] = {
            "pool": {"directories_to_include": [corpus["noise"]],
                     "extension": "", "probability": 0.7,
                     "mix": {"other": 0.5}},
            "other": {"directories_to_include": [corpus["long"]],
                      "extension": ".wav", "probability": 0.3}}
        cfg["input"]["rir"] = {"pool": {"csv": str(root / "rir_test.csv"),
                                        "base_dir": corpus["rirs"],
                                        "prob": 1.0}}
        cfg["nearend"]["rir"] = {"prob": 0.5}
    path = root / ("aec.yaml" if farend else "se_test.yaml")
    path.write_text(yaml_subset.dump(cfg))
    return str(path)


# case -> (tool, argv(corpus root, corpus dirs, out dir), shard dir under
# out, ShardSource fields)
ADAPTER_CASES = {
    "shard_speech": ("shard_speech", lambda r, c, o: [
        "-n", "sp", "-d", c["speech"], "-s", o], "sp", ("recording",)),
    "shard_noise": ("shard_noise", lambda r, c, o: [
        "-n", "nz", "-d", c["noise"], "-s", o, "--chunk-sec", "1.0",
        "--min-sec", "0.9"], "nz", ("recording",)),
    "shard_noise-mono": ("shard_noise", lambda r, c, o: [
        "-n", "nz", "-d", c["noise"], "-s", o, "--chunk-sec", "1.0",
        "--min-sec", "0.9", "--mono"], "nz", ("recording",)),
    "shard_dns_rir": ("shard_dns_rir", lambda r, c, o: [
        "-n", "rir", "--csv", str(r / "dns_rir.csv"), "-d", c["rirs"],
        "-s", o], "rir", ("recording",)),
    "shard_vctk-train": ("shard_vctk", lambda r, c, o: [
        "-n", "vc", "-d", c["vctk"], "-s", o], "vc", ("recording",)),
    "shard_vctk-test": ("shard_vctk", lambda r, c, o: [
        "-n", "vc", "-d", c["vctk"], "-s", o, "--split", "test"], "vc",
        ("recording",)),
    "shard_demand-train": ("shard_demand", lambda r, c, o: [
        "-n", "dm", "-d", c["demand"], "-s", o, "--chunk-sec", "1.0",
        "--min-sec", "0.5"], "dm", ("recording",)),
    "shard_demand-test": ("shard_demand", lambda r, c, o: [
        "-n", "dm", "-d", c["demand"], "-s", o, "--split", "test",
        "--chunk-sec", "1.0", "--min-sec", "0.5"], "dm", ("recording",)),
    "shard_hifitts1": ("shard_hifitts1", lambda r, c, o: [
        "-n", "hf", "-d", c["speech"], "-s", o, "-e", "wav",
        "--shard-size", "2"], "hf", ("recording",)),
    "shard_brudex": ("shard_brudex", lambda r, c, o: [
        "-n", "br", "-b", c["brudex"], "-s", o], "br", ("recording",)),
    "shard_myriad": ("shard_myriad", lambda r, c, o: [
        "-n", "my", "-b", c["myriad"], "-s", o], "my", ("recording",)),
    "shard_test-noise-rir": ("shard_test", lambda r, c, o: [
        "-n", "ts", "-c", make_testset_config(r, c, False), "-s", o,
        "--seed", "3", "--shard-size", "2"], "ts",
        ("recording", "rir", "noise")),
    "shard_test-farend": ("shard_test", lambda r, c, o: [
        "-n", "ts", "-c", make_testset_config(r, c, True), "-s", o,
        "--seed", "5"], "ts", ("recording", "farend", "echo")),
    "shard_wavdir": ("shard_wavdir", lambda r, c, o: [
        "-i", c["speech"], "-o", os.path.join(o, "wd"), "--shard-size",
        "2"], "wd", ("recording",)),
    "shard_wavdir-segment": ("shard_wavdir", lambda r, c, o: [
        "-i", c["long"], "-o", os.path.join(o, "wd"), "--segment"], "wd",
        ("recording",)),
    "shard_wavdir-rir": ("shard_wavdir", lambda r, c, o: [
        "-i", c["rirs"], "-o", os.path.join(o, "wd"), "--kind", "rir"],
        "wd", ("recording",)),
}


def output_tree(root):
    """{relative path: content} of everything a builder wrote: a cut list
    decompressed, any other file's bytes (tars, the .done marker)."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                data = f.read()
            out[os.path.relpath(p, root)] = (gzip.decompress(data)
                                             if n.endswith(".gz") else data)
    return out


def read_back(source):
    return [(c.id, c.duration, c.custom, c.sup, c.audio,
             sorted(c.extras.items())) for c in source.iter_cuts(seed=0)]


def assert_cuts_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        assert g[4].dtype == w[4].dtype and np.array_equal(g[4], w[4])
        assert [k for k, _ in g[5]] == [k for k, _ in w[5]]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(g[5],
                                                                  w[5]))


@pytest.mark.parametrize("case", list(ADAPTER_CASES))
def test_sharder_equals_jax(tmp_path, monkeypatch, case):
    tool, argv, shard, fields = ADAPTER_CASES[case]
    corpus = write_corpus(tmp_path / "corpus")
    jax_main = importlib.import_module(f"scripts.data.{tool}").main
    port_main = importlib.import_module(
        f"fastenhancer_tpu_torch.scripts.data.{tool}").main
    jobs = [] if tool == "shard_wavdir" else ["-j", "1"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    root = tmp_path / "corpus"
    if tool == "shard_wavdir":  # JAX's main() parses sys.argv only
        monkeypatch.setattr(sys, "argv", [tool] + argv(root, corpus,
                                                        jax_out))
        jax_main()
    else:
        jax_main(argv(root, corpus, jax_out) + jobs)
    port_main(argv(root, corpus, port_out) + jobs)
    want = output_tree(jax_out)
    assert any(k.endswith(".tar") for k in want), sorted(want)
    assert output_tree(port_out) == want
    assert_cuts_equal(
        read_back(ShardSource(os.path.join(port_out, shard), fields=fields)),
        read_back(JaxShardSource(os.path.join(jax_out, shard),
                                 fields=fields)))


def test_shard_test_spawned_jobs_equal_jax(tmp_path):
    """The port's test-set builder at -j 2 (two spawned workers, each
    building its samplers in `_init_worker`) writes what its -j 1 and
    JAX's -j 1 write, tar for tar."""
    from fastenhancer_tpu_torch.scripts.data import shard_test as port
    from scripts.data import shard_test as jax_tool

    corpus = write_corpus(tmp_path / "corpus")
    config = make_testset_config(tmp_path / "corpus", corpus, False)
    trees = []
    for run, main, jobs in (("jax", jax_tool.main, "1"),
                            ("port1", port.main, "1"),
                            ("port2", port.main, "2")):
        with deadline(POOL_TIMEOUT, f"shard_test -j {jobs}"):
            main(["-n", "ts", "-c", config, "-s", str(tmp_path / run),
                  "--seed", "7", "--shard-size", "2", "-j", jobs])
        trees.append(output_tree(str(tmp_path / run)))
    assert sum(k.endswith(".tar") for k in trees[0]) == 9  # 3 shards x 3
    assert trees[1] == trees[0] and trees[2] == trees[0]


def test_run_adapter_marker_and_stale_cleanup_equal_jax(tmp_path, capsys):
    """A crashed earlier build (shards, no marker) is cleaned; a finished
    one (marker) is kept unless -f; as JAX's run_adapter does."""
    from fastenhancer_tpu_torch.scripts.data import shard_speech as port
    from scripts.data import shard_speech as jax_tool

    corpus = write_corpus(tmp_path / "corpus")
    for run, main in (("jax", jax_tool.main), ("port", port.main)):
        out = tmp_path / run
        (out / "sp").mkdir(parents=True)
        (out / "sp" / "cuts.000007.jsonl.gz").write_bytes(b"stale")
        argv = ["-n", "sp", "-d", corpus["speech"], "-s", str(out), "-j", "1"]
        main(argv)
        assert not (out / "sp" / "cuts.000007.jsonl.gz").exists()
        before = output_tree(str(out))
        capsys.readouterr()
        main(argv[:-2] + ["-d", corpus["vctk"], "-j", "1"])
        assert "use --force" in capsys.readouterr().out
        assert output_tree(str(out)) == before
        main(argv[:-2] + ["-d", corpus["vctk"], "-j", "1", "-f"])
    assert output_tree(str(tmp_path / "port")) == output_tree(
        str(tmp_path / "jax"))


def test_samplers_draw_as_jax(tmp_path):
    """corpus_utils' samplers on a `random.Random(s)` draw what JAX's draw
    from the module-level `random` after `random.seed(s)`."""
    import random

    from fastenhancer_tpu_torch.scripts.data import corpus_utils as port
    from scripts.data import corpus_utils as jax_cu

    corpus = write_corpus(tmp_path / "corpus")
    pools = {"a": {"directories_to_include": [corpus["noise"]],
                   "extension": "", "probability": 0.5,
                   "mix": {"b": 0.6}},
             "b": {"directories_to_include": [corpus["speech"]],
                   "extension": ".wav", "probability": 0.5}}
    kw = dict(fs=SR, silence_length=0.1, activity_threshold_relative=-25.0)
    rir_hps = {"p": {"csv": str(tmp_path / "corpus" / "rir_test.csv"),
                     "base_dir": corpus["rirs"], "prob": 1.0}}
    for seed in range(4):
        random.seed(seed)
        want = (jax_cu.DirectoriesDataset(pools, **kw)(1.7),
                jax_cu.ReverbDataset(SR, rir_hps)())
        rng = random.Random(seed)
        got = (port.DirectoriesDataset(pools, **kw)(1.7, rng),
               port.ReverbDataset(SR, rir_hps)(rng))
        assert got[0][1] == want[0][1]
        assert np.array_equal(got[0][0], want[0][0])
        assert np.array_equal(got[1][0], want[1][0])
        assert got[1][1:] == want[1][1:]
        assert rng.random() == random.random()


@pytest.mark.parametrize("keep_rir", [True, False])
def test_frozen_rir_set_mixes_on_port_mixer(tmp_path, keep_rir):
    """The port builds the frozen RIR set, its reader reads it back, and
    its DynamicMixer (the plain CPU path of #4) mixes it: each row of the
    mixed input correlates with the direct convolution of speech and RIR
    above 0.9999. The control drops the RIR and must miss that bound."""
    from fastenhancer_tpu_torch.data.shard_mixer import (DynamicMixer,
                                                         batch_convolve_rir)
    from fastenhancer_tpu_torch.scripts.data.shard_test import main

    corpus = write_corpus(tmp_path / "corpus")
    main(["-n", "rirset", "-c", make_testset_config(tmp_path / "corpus", corpus,
                                               False),
          "-s", str(tmp_path / "shards"), "-j", "1"])
    src = ShardSource(str(tmp_path / "shards" / "rirset"),
                      fields=("recording", "rir", "noise"))
    cuts = [c for c in sorted(src.iter_cuts(seed=0), key=lambda c: int(c.id))
            if c.custom["rms"] > 0 and len(c.audio) >= SR]
    assert len(cuts) == 3
    assert all(len(c.extras["rir"]) != len(c.audio) for c in cuts)
    # a batch as ShardDataset assembles it: the RIR padded into a 0.5 s
    # buffer
    t, t_rir, b = min(len(c.audio) for c in cuts), SR // 2, len(cuts)
    speech = torch.from_numpy(np.stack([c.audio[:t] for c in cuts])[:, None])
    rir = torch.zeros(b, 1, t_rir)
    for i, c in enumerate(cuts):
        rir[i, 0, :len(c.extras["rir"])] = torch.from_numpy(c.extras["rir"])
    onset = torch.tensor([c.custom["rir_onset"] for c in cuts])
    t60 = torch.tensor([c.custom["rir_t60"] for c in cuts],
                       dtype=torch.float32)
    mixer = DynamicMixer(speech_dbFS=(-20.0, -20.0), snr=(40.0, 40.0),
                         sampling_rate=SR, rir_target_type="early_rir")
    out = mixer(torch.Generator().manual_seed(0), speech,
                speech_clean=speech, noise=torch.zeros_like(speech),
                rir=rir if keep_rir else None,
                rir_onset=onset if keep_rir else None,
                rir_t60=t60 if keep_rir else None)
    direct = batch_convolve_rir(speech, rir)[:, 0].double()
    got = out["speech"][:, 0].double()
    corr = ((got * direct).sum(-1) / (got.norm(dim=-1)
                                      * direct.norm(dim=-1))).tolist()
    if keep_rir:
        assert min(corr) > 0.9999, corr
    else:
        assert max(corr) <= 0.9999, corr


def test_tools_start_without_torch():
    """The corpus tools are host code: importing every one of them (and
    the reader's wav and config modules they use) imports no torch, so a
    tool and each of its spawned workers start without it."""
    import subprocess

    code = ("import pkgutil, importlib, sys\n"
            "import fastenhancer_tpu_torch.scripts.data as pkg\n"
            "for m in pkgutil.iter_modules(pkg.__path__):\n"
            "    importlib.import_module(f'{pkg.__name__}.{m.name}')\n"
            "import fastenhancer_tpu_torch.scripts.audiolib\n"
            "from fastenhancer_tpu_torch.data import read_wav\n"
            "from fastenhancer_tpu_torch.utils.hparams import get_hparams\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "print(len(list(pkgutil.iter_modules(pkg.__path__))))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["19"]
