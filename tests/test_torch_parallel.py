"""The port's several-rank plumbing against the JAX package's, in one
process: the batch-shape agreement of the wrappers (`_reconcile_multihost`
and the shard and on-the-fly branches), the loader's per-rank stride and
the shard reader's per-rank seed.

As tests/test_multihost_unit.py does for JAX, a two-rank world is faked:
the port's `parallel.world`/`rank`/`all_gather_ints` and JAX's
`process_count`/`process_allgather` are patched so that the peer reports
`peer(local)`. Both packages then get the same inputs. JAX's wrapper is
given n_devices=2 (one device a process, as the port has one card a
rank), and both must pad and cut every array alike, bit for bit, and
raise alike.
"""
import types

import jax
import numpy as np
import pytest
import torch

from fastenhancer_tpu.data import get_dataset_dataloader as jget_loader
from fastenhancer_tpu.data.loader import DataLoader as JDataLoader
from fastenhancer_tpu.utils.hparams import HParams as JHParams
from fastenhancer_tpu.wrappers.ns import ModelWrapper as JNS
from fastenhancer_tpu.wrappers.ns_on_the_fly import ModelWrapper as JOTF
from fastenhancer_tpu.wrappers.ns_shard import ModelWrapper as JShard
from fastenhancer_tpu_torch import parallel
from fastenhancer_tpu_torch.data import get_dataset_dataloader
from fastenhancer_tpu_torch.data.loader import DataLoader
from fastenhancer_tpu_torch.utils.hparams import HParams
from fastenhancer_tpu_torch.wrappers.ns import ModelWrapper as TNS
from fastenhancer_tpu_torch.wrappers.ns_on_the_fly import ModelWrapper as TOTF
from fastenhancer_tpu_torch.wrappers.ns_shard import ModelWrapper as TShard

from _torch_dist import free_port
from _torch_parity import SR, write_shard_dir, torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

HOP = 256


def bare(cls, port):
    w = cls.__new__(cls)
    w.n_devices = 2
    w.hop_size = HOP
    w._mh_dims_cache = {}
    if port:
        w.device = torch.device("cpu")
    else:
        w.mesh = None
    return w


class FakeWorld:
    """Both packages in a two-rank world whose peer reports peer(local);
    counts the gathers each package makes."""

    def __init__(self, monkeypatch, peer):
        self.calls = {"port": 0, "jax": 0}
        from jax.experimental import multihost_utils

        def gather(who):
            def fn(x):
                self.calls[who] += 1
                local = np.asarray(x, np.int64).reshape(-1)
                return np.stack([local, np.asarray(peer(local.copy()))])
            return fn

        monkeypatch.setattr(parallel, "all_gather_ints", gather("port"))
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(multihost_utils, "process_allgather",
                            gather("jax"))


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def both(monkeypatch, peer, arrs, shared, **kw):
    world = FakeWorld(monkeypatch, peer)
    got = bare(TNS, True)._reconcile_multihost(
        {k: v.copy() for k, v in arrs.items()}, shared, **kw)
    want = bare(JNS, False)._reconcile_multihost(
        {k: v.copy() for k, v in arrs.items()}, shared, **kw)
    assert_same(got, want)
    assert world.calls == {"port": 1, "jax": 1}
    return got


def _sig(rows=None, t=None, extra=None):
    def peer(s):
        if rows is not None:
            s[1] = rows
        if t is not None:
            s[2] = t
        if extra is not None:
            s[3] = extra
        return s
    return peer


def test_reconcile_pads_rows_and_time_and_pads_rir():
    """The peer has more rows and longer audio and RIRs: every rank pads
    to the hop-floored longest shared time, rir to its longest, rows to
    the most rows (masked); the real samples are kept."""
    arrs = {"clean": np.ones((2, 1000), np.float32),
            "noise": np.ones((2, 990), np.float32),
            "rir": np.ones((2, 1, 800), np.float32),
            "row_mask": np.ones(2, np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        out = both(mp, _sig(rows=3, t=1100, extra=900), arrs,
                   ("clean", "noise"))
    assert out["clean"].shape == out["noise"].shape == (3, 1024)
    assert out["rir"].shape == (3, 1, 900)
    np.testing.assert_array_equal(out["row_mask"], [1, 1, 0])
    assert np.all(out["clean"][:2, :1000] == 1) and not out["clean"][2].any()


def test_reconcile_cuts_time_to_the_ranks_longest():
    arrs = {"clean": np.ones((1, 1030), np.float32),
            "row_mask": np.ones(1, np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        out = both(mp, _sig(t=700), arrs, ("clean",))
    assert out["clean"].shape == (1, 1024)


def test_reconcile_static_shapes_gather_once_and_raise_on_change(
        monkeypatch):
    world = FakeWorld(monkeypatch, lambda s: s)
    arrs = {"clean": np.ones((2, 512), np.float32),
            "row_mask": np.ones(2, np.float32)}
    bad = {"clean": np.ones((3, 512), np.float32),
           "row_mask": np.ones(3, np.float32)}
    for cls, port, who in ((TNS, True, "port"), (JNS, False, "jax")):
        w = bare(cls, port)
        for _ in range(3):
            w._reconcile_multihost(arrs, ("clean",), static_shapes=True)
        # a changed signature raises before any collective
        with pytest.raises(RuntimeError, match="static_shapes"):
            w._reconcile_multihost(bad, ("clean",), static_shapes=True)
        assert world.calls[who] == 1


def test_reconcile_raises_on_key_set_divergence(monkeypatch):
    def peer(s):
        s[0] += 1
        return s

    FakeWorld(monkeypatch, peer)
    arrs = {"clean": np.ones((1, 512), np.float32),
            "row_mask": np.ones(1, np.float32)}
    for cls, port in ((TNS, True), (JNS, False)):
        with pytest.raises(RuntimeError, match="key sets differ"):
            bare(cls, port)._reconcile_multihost(arrs, ("clean",))


def _shard_batch():
    rng = np.random.default_rng(0)
    return types.SimpleNamespace(
        speech=rng.standard_normal((2, 1, 2000)).astype(np.float32),
        speech_clean=rng.standard_normal((2, 1, 2000)).astype(np.float32),
        noise=rng.standard_normal((2, 1, 2000)).astype(np.float32),
        rir=rng.standard_normal((2, 1, 1200)).astype(np.float32),
        rir_onset=np.asarray([3, 5], np.int32),
        rir_t60=np.asarray([0.3, 0.5], np.float32),
        echo=None, is_real=None)


def test_shard_branch_matches_jax(monkeypatch):
    """ns_shard._mix_to_device at rank 0 of 2: the peer has a bigger
    length bucket and longer RIRs; the mixer gets JAX's padded arrays,
    and draws for the global batch (share=(0, 2))."""
    import fastenhancer_tpu.wrappers.ns_shard as jmod

    world = FakeWorld(monkeypatch, _sig(rows=3, t=2100, extra=1500))
    monkeypatch.setattr(jmod, "shard_batch", lambda batch, mesh: batch)
    seen = {}

    def mixer(who):
        def fn(_, speech, speech_clean, noise, rir, rir_onset, rir_t60,
               echo=None, is_real=None, share=None):
            seen[who] = dict(speech=speech, speech_clean=speech_clean,
                             noise=noise, rir=rir, rir_onset=rir_onset,
                             rir_t60=rir_t60, share=share)
            return {"speech": speech, "speech_clean": speech_clean}
        return fn

    tw, jw = bare(TShard, True), bare(JShard, False)
    tw.mixer, jw.mixer = mixer("port"), mixer("jax")
    tw.mix_generator = torch.Generator().manual_seed(0)
    jw._mix_key = jax.random.PRNGKey(0)
    tout, trows = tw._mix_to_device(_shard_batch())
    jout, jrows = jw._mix_to_device(_shard_batch())
    assert trows == jrows == 2
    assert world.calls == {"port": 1, "jax": 1}
    assert seen["port"].pop("share") == (0, 2)
    seen["jax"].pop("share")
    assert_same(seen["port"], seen["jax"])
    assert seen["port"]["speech"].shape == (3, 1, 2048)
    assert seen["port"]["rir"].shape == (3, 1, 1500)
    assert_same(tout, jout)


def test_on_the_fly_branch_matches_jax(monkeypatch):
    """ns_on_the_fly._device_batch at rank 0 of 2 with the ragged tail
    batch (the peer has 4 rows): padded, masked, rir padded not cut; the
    low-pass kernels are drawn for the 8 global rows and this rank takes
    rows 0-3 (JAX draws for its global batch of 8 in one program)."""
    world = FakeWorld(monkeypatch, _sig(rows=4, extra=700))
    import fastenhancer_tpu.parallel as jpar

    monkeypatch.setattr(jpar, "shard_batch", lambda batch, mesh: batch)

    class FakeSNRMixer:
        def sample_params(self):
            return 5.0, 0.1

        def __call__(self, clean, noise, snr, rms, rir=None):
            self.rir = rir
            return clean, noise, clean + noise

    drawn = []

    class FakeLPF:
        p_lpf = 0.5

        def sample_kernels(self, b, rng):
            drawn.append(b)
            return np.arange(b, dtype=np.float32)[:, None] * np.ones(3)

        def __call__(self, wav, kernels):
            self.kernels = np.asarray(kernels)
            return wav

    tw, jw = bare(TOTF, True), bare(JOTF, False)
    for w in (tw, jw):
        w.snr_mixer, w.dynamic_lpf, w._lpf_rng = FakeSNRMixer(), FakeLPF(), 0
    rng = np.random.default_rng(1)
    batch = {"clean": rng.standard_normal((3, 2100)).astype(np.float32),
             "noise": rng.standard_normal((3, 2048)).astype(np.float32),
             "rir": rng.standard_normal((3, 600)).astype(np.float32)}
    tout, trows = tw._device_batch(batch, ("clean", "noisy"))
    jout, jrows = jw._device_batch(dict(batch), ("clean", "noisy"))
    assert trows == jrows == 3
    assert world.calls == {"port": 1, "jax": 1}
    assert_same(tout, jout)
    np.testing.assert_array_equal(tout["row_mask"], [1, 1, 1, 0])
    assert tw.snr_mixer.rir.shape == (4, 700)
    np.testing.assert_array_equal(np.asarray(tw.snr_mixer.rir),
                                  np.asarray(jw.snr_mixer.rir))
    # JAX draws for its padded global batch of 4 rows on one process; the
    # port draws the 8 rows of both ranks and keeps its own 4
    assert drawn == [8, 4]
    np.testing.assert_array_equal(tw.dynamic_lpf.kernels[:, 0], range(4))


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full(4, i, np.float32)}


@pytest.mark.parametrize("n,batch,world,drop_last", [
    (10, 2, 2, False), (11, 3, 2, False), (11, 3, 2, True), (7, 2, 3, False),
    (4, 4, 2, False)])
def test_loader_stride_matches_jax(n, batch, world, drop_last):
    """Each rank's batches equal JAX's; the ranks' counts are equal, their
    real batches disjoint, and the wrap padding repeats the first ones."""
    per_rank = []
    for r in range(world):
        port = DataLoader(_Items(n), batch, drop_last=drop_last,
                          process_stride=(r, world))
        jax_ = JDataLoader(_Items(n), batch, drop_last=drop_last,
                           process_stride=(r, world))
        assert port._index_batches() == jax_._index_batches()
        assert len(port) == len(jax_) == len(port._index_batches())
        got = [b["x"][:, 0].astype(int).tolist() for b in port]
        assert got == port._index_batches()
        per_rank.append(got)
    assert len({len(b) for b in per_rank}) == 1
    flat = [tuple(b) for bs in per_rank for b in bs]
    everything = DataLoader(_Items(n), batch, drop_last=drop_last)
    real = [tuple(b) for b in everything._index_batches()]
    assert set(flat) == set(real)
    assert len(flat) - len(real) == (-len(real)) % world


def test_shard_reader_at_rank_1_draws_as_jax(tmp_path, monkeypatch):
    """The shard reader at rank 1 of 2 (epoch_seed + worker + 1000*rank)
    gives JAX's reader's batches at rank 1 bit for bit, and not rank 0's."""
    dirs = {"speech": write_shard_dir(tmp_path, "speech", seed=1,
                                      dur=(0.6, 2.0)),
            "noise": write_shard_dir(tmp_path, "noise", seed=3,
                                     dur=(0.3, 1.0))}
    cfg = {"data": {"dataset": "ShardOnTheFly", "sampling_rate": SR,
                    "max_duration": 4.0, "train": {
                        "inputs": {"speech": [{"shard_dir": dirs["speech"]}],
                                   "noise": [{"shard_dir": dirs["noise"]}]},
                        "num_buckets": 5, "min_utt_duration": 0.1,
                        "prob_noise": 0.7, "aux_buffer_size": 6,
                        "num_workers": 1}}}
    keys = ["speech", "speech_clean", "noise"]

    def batches(loader):
        loader.shuffle(3)
        return [(b.speech, b.noise) for b in loader]

    _, rank0 = get_dataset_dataloader(HParams(**cfg), "train", keys)
    monkeypatch.setattr(parallel, "world", lambda: 2)
    monkeypatch.setattr(parallel, "rank", lambda: 1)
    _, port = get_dataset_dataloader(HParams(**cfg), "train", keys)
    _, jax_ = jget_loader(JHParams(**cfg), "train", keys, rank=1)
    assert port.rank == 1
    got, want, first = batches(port), batches(jax_), batches(rank0)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(g[1], f[1]) for g, f in zip(got, first))


def test_no_silent_fallback_to_one_rank():
    """A group that cannot start raises: NCCL on a machine without it, and
    the default device without a card; nothing joins as world 1."""
    import torch.distributed as dist

    coordinator = f"127.0.0.1:{free_port()}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.init(coordinator, 1, 0)
    if not dist.is_nccl_available():
        with pytest.raises((RuntimeError, ValueError)):
            parallel.init(coordinator, 1, 0, backend="nccl", device="cpu")
    assert not dist.is_initialized()
    assert parallel.world() == 1 and parallel.rank() == 0
