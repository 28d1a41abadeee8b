"""The training summaries without tensorboardX (utils/event_file.py,
utils/summarize.py, functional/mel.py::spec_to_mel) against the JAX
package's `summarize`, which writes through tensorboardX. Both files are
read back record by record, every masked CRC checked with tensorboardX's
own CRC-32C, and decoded with tensorboard's protobuf classes (test-only:
the port writes the wire format by hand). Scalars are float32 on both
sides and equal; histograms (tensorboardX's default "tensorflow" buckets)
equal in min, max, num, bucket limits and counts, sum and sum of squares
to rtol 1e-6; audio bytes, rate and length equal. The spectrogram image
is a divergence (matplotlib is absent on the card): the port's PNG
decodes to the documented [F, T, 3] uint8 array."""
import io
import os
import struct

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from tensorboard.compat.proto import event_pb2
from tensorboardX import SummaryWriter
from tensorboardX.crc32c import crc32c as tbx_crc32c
from tensorboardX.record_writer import masked_crc32c as tbx_masked_crc32c

from fastenhancer_tpu.functional.mel import spec_to_mel as jax_spec_to_mel
from fastenhancer_tpu.models import get_model as jax_get_model
from fastenhancer_tpu.utils.summarize import (
    plot_param_and_grad as jax_plot_param_and_grad)
from fastenhancer_tpu.utils.summarize import summarize as jax_summarize
from fastenhancer_tpu_torch.functional import spec_to_mel
from fastenhancer_tpu_torch.utils.event_file import (EventWriter, crc32c,
                                                     decode_png,
                                                     masked_crc32c,
                                                     read_events)
from fastenhancer_tpu_torch.utils.summarize import (COLORMAP,
                                                    plot_param_and_grad,
                                                    plot_spectrogram_to_numpy,
                                                    summarize)

from _torch_parity import (TINY_KWARGS, port_variables,
                           torch_one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SR = 16_000


def _records(path):
    """Each record's payload of a TFRecord file, both CRCs checked with
    tensorboardX's implementation."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == \
            tbx_masked_crc32c(head)
        payload = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == \
            tbx_masked_crc32c(payload)
        out.append(payload)
        i += 16 + n
    return out


def _events(logdir):
    (name,) = os.listdir(logdir)
    assert name.startswith("events.out.tfevents.")
    return [event_pb2.Event.FromString(r)
            for r in _records(os.path.join(logdir, name))]


def _summaries(rng):
    t = np.linspace(0, 1, 4000, dtype=np.float32)
    return {
        "scalars": {"loss/wav_l1": 0.123456789, "lr": np.float32(3e-4),
                    "metrics/pesq": 2.5},
        "hists": {
            "param/a/0/w": rng.standard_normal((7, 5)).astype(np.float32),
            "param/zeros": np.zeros(11, np.float32),
            "grad/b": np.concatenate([
                rng.standard_normal(300).astype(np.float32) * 1e-6,
                [np.nan, np.inf, -np.inf, 2e3]]).astype(np.float32),
            "grad/all_nan": np.full(4, np.nan, np.float32),
            "param/big": (rng.standard_normal(5000) * 30).astype(np.float32)},
        "audios": {"clean/00": (np.sin(2e3 * t) * 0.5).astype(np.float32),
                   "enhanced/00": (rng.standard_normal(4000) * 0.7)
                   .astype(np.float32),
                   "noisy/00": (np.sin(900 * t) * 2.0).astype(np.float32)},
        "specs": {"enhanced/00": rng.standard_normal((33, 21))
                  .astype(np.float32)}}


def _write_both(tmp_path, summaries, epochs=(1, 3)):
    jw = SummaryWriter(str(tmp_path / "jax"))
    tw = EventWriter(str(tmp_path / "port"))
    for e in epochs:
        jax_summarize(jw, e, SR, **summaries)
        summarize(tw, e, SR, **summaries)
    jw.close()
    tw.close()
    return _events(str(tmp_path / "jax")), _events(str(tmp_path / "port"))


def _keyed(events):
    return [(e.step, v.tag, v.WhichOneof("value"))
            for e in events for v in e.summary.value]


def test_summarize_matches_jax_through_tensorboardx(tmp_path):
    summaries = _summaries(np.random.default_rng(0))
    jev, tev = _write_both(tmp_path, summaries)
    assert jev[0].file_version == tev[0].file_version == "brain.Event:2"
    assert _keyed(jev) == _keyed(tev)
    kinds = {k for _, _, k in _keyed(tev)}
    assert kinds == {"simple_value", "histo", "audio", "image"}
    # the all-NaN histogram is skipped on both sides
    assert not any(t == "grad/all_nan" for _, t, _ in _keyed(tev))
    jvals = [v for e in jev for v in e.summary.value]
    tvals = [v for e in tev for v in e.summary.value]
    for j, t in zip(jvals, tvals):
        kind = t.WhichOneof("value")
        if kind == "simple_value":
            assert t.simple_value == j.simple_value
        elif kind == "histo":
            for f in ("min", "max", "num"):
                assert getattr(t.histo, f) == getattr(j.histo, f), f
            assert list(t.histo.bucket_limit) == list(j.histo.bucket_limit)
            assert list(t.histo.bucket) == list(j.histo.bucket)
            np.testing.assert_allclose(t.histo.sum, j.histo.sum, rtol=1e-6)
            np.testing.assert_allclose(t.histo.sum_squares,
                                       j.histo.sum_squares, rtol=1e-6)
        elif kind == "audio":
            assert t.audio.encoded_audio_string == j.audio.encoded_audio_string
            assert t.audio.sample_rate == j.audio.sample_rate == SR
            assert t.audio.length_frames == j.audio.length_frames
            assert t.audio.num_channels == j.audio.num_channels == 1
            assert t.audio.content_type == j.audio.content_type
        else:
            spec = summaries["specs"][t.tag]
            assert (t.image.height, t.image.width, t.image.colorspace) == (
                *spec.shape, 3)
            img = np.asarray(Image.open(io.BytesIO(
                t.image.encoded_image_string)))
            assert img.dtype == np.uint8 and img.shape == (*spec.shape, 3)
            np.testing.assert_array_equal(img,
                                          plot_spectrogram_to_numpy(spec))
            np.testing.assert_array_equal(
                decode_png(t.image.encoded_image_string), img)


def test_nonfinite_values_dropped_and_loud_audio_normalised(tmp_path):
    rng = np.random.default_rng(1)
    finite = rng.standard_normal(50).astype(np.float32)
    loud = (rng.standard_normal(800) * 3).astype(np.float32)
    summaries = {"hists": {"h": np.concatenate([finite, [np.nan, np.inf]])
                           .astype(np.float32)},
                 "audios": {"a": loud}}
    _, tev = _write_both(tmp_path, summaries, epochs=(2,))
    (h, a) = [v for e in tev for v in e.summary.value]
    assert h.histo.num == 50
    assert h.histo.min == float(finite.min())
    assert h.histo.max == float(finite.max())
    pcm = np.frombuffer(a.audio.encoded_audio_string[44:], "<i2")
    want = np.clip(loud / np.abs(loud).max() * 32768.0, -32768,
                   32767).astype("<i2")
    np.testing.assert_array_equal(pcm, want)
    assert np.abs(pcm.astype(np.int32)).max() >= 32767


def test_event_file_crc_and_reader(tmp_path):
    for n in (0, 9, 4095, 4096, 70_001, (1 << 20) + 3):
        data = np.random.default_rng(n).bytes(n)
        assert crc32c(data) == tbx_crc32c(data) & 0xFFFFFFFF, n
        assert masked_crc32c(data) == tbx_masked_crc32c(data), n
    assert crc32c(b"123456789") == 0xE3069283
    summaries = _summaries(np.random.default_rng(2))
    jev, _ = _write_both(tmp_path, summaries)
    port_dir = tmp_path / "port"
    (name,) = os.listdir(port_dir)
    events = read_events(str(port_dir / name))
    assert events[0]["file_version"] == "brain.Event:2"
    assert [(e["step"], tag, kind) for e in events
            for tag, kind, _ in e["values"]] == _keyed(jev)
    got = {(e["step"], tag, kind): v for e in events
           for tag, kind, v in e["values"]}
    assert got[(1, "lr", "simple_value")] == np.float32(3e-4)
    assert got[(3, "clean/00", "audio")]["length_frames"] == 4000
    # a flipped byte fails the payload's CRC
    path = port_dir / name
    raw = bytearray(path.read_bytes())
    raw[-10] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        read_events(str(path))


def test_spectrogram_image_layout():
    spec = np.arange(12, dtype=np.float32).reshape(3, 4)
    img = plot_spectrogram_to_numpy(spec)
    assert img.shape == (3, 4, 3) and img.dtype == np.uint8
    # origin at the bottom: the last frequency row is the image's first
    np.testing.assert_array_equal(img[0, 3], COLORMAP[255])
    np.testing.assert_array_equal(img[2, 0], COLORMAP[0])
    assert (plot_spectrogram_to_numpy(np.ones((2, 2))) == COLORMAP[0]).all()


@pytest.mark.parametrize("sr", [16_000, 48_000])
def test_spec_to_mel_matches_jax(sr):
    mag = np.abs(np.random.default_rng(sr).standard_normal(
        (513, 40))).astype(np.float32)
    np.testing.assert_allclose(spec_to_mel(mag, sr=sr),
                               jax_spec_to_mel(mag, sr=sr), rtol=1e-5)


def test_plot_param_and_grad_tags_match_jax():
    jm = jax_get_model("fastenhancer.default", **TINY_KWARGS)
    jv = jm.init(jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda x: x * 2.0, jv["params"])
    jh, th = {}, {}
    jax_plot_param_and_grad(jh, jv["params"], grads=grads)
    tv = port_variables(jv)
    tgrads = port_variables({"params": grads})["params"]
    plot_param_and_grad(th, tv["params"], grads=tgrads)
    assert set(th) == set(jh)
    assert {k.split("/")[0] for k in th} == {"param", "grad"}
    for k, v in th.items():
        np.testing.assert_array_equal(v, np.asarray(jh[k]), err_msg=k)
    params_only = {}
    plot_param_and_grad(params_only, tv["params"])
    assert set(params_only) == {k for k in th if k.startswith("param/")}
    # device tensors and bf16 become float32 host arrays
    one = {}
    plot_param_and_grad(one, {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert one["param/w"].dtype == np.float32


def test_summarize_takes_tensors(tmp_path):
    w = EventWriter(str(tmp_path))
    summarize(w, 1, SR, scalars={"s": torch.tensor(1.5)},
              hists={"h": torch.arange(4.0)},
              audios={"a": torch.zeros(100)}, specs={"p": torch.ones(5, 6)})
    w.close()
    values = [v for e in read_events(w.path) for v in e["values"]]
    assert [(t, k) for t, k, _ in values] == [
        ("s", "simple_value"), ("h", "histo"), ("a", "audio"), ("p", "image")]
    assert values[0][2] == 1.5
    assert values[1][2]["num"] == 4.0
    assert (values[3][2]["height"], values[3][2]["width"]) == (5, 6)
