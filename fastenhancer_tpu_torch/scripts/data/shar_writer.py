"""Reusable lhotse-shar-compatible shard writer + adapter harness.

The port's scripts/data/shar_writer.py. Every per-corpus builder shares
one skeleton (reference: scripts/data/shard_speech.py:216-258): collect
files, process each in a worker pool (resample, filter, corpus quirks,
custom metadata), stream cuts into shards of 1000. `ShardWriter` writes
the on-disk contract the reader consumes (data/shard.py:
cuts.NNNNNN.jsonl.gz + recording.NNNNNN.tar) without lhotse;
`run_adapter` is the pool/progress/done-marker harness the per-corpus
CLIs plug into. The pool is spawned: `process_one`, its arguments and an
`initializer` must pickle, and per-worker state is rebuilt in each
worker.

Audio is stored as 16-bit wav (no flac encoder here; the reader accepts
flac too when soundfile is installed).
"""
from __future__ import annotations

import gzip
import io
import json
import multiprocessing
import os
import tarfile
import typing as tp
import wave as wave_mod
from concurrent.futures import ProcessPoolExecutor

import numpy as np

Cut = tp.Dict[str, tp.Any]  # {"id", "audio", "sr"[, "custom"]}


def wav_bytes(x: np.ndarray, sr: int, float32: bool = False) -> bytes:
    """Mono wav encode: PCM16, or IEEE-float32 (format 3) for payloads
    that must not be quantized/clipped, e.g. RIR fields (the reference's
    test-set builder stores RIRs as raw numpy arrays,
    scripts/data/shard_test.py:150-158)."""
    if float32:
        import struct

        data = np.asarray(x, "<f4").tobytes()
        # RIFF size = "WAVE"(4) + fmt(8+18) + fact(8+4) + data hdr(8) + data
        return (b"RIFF" + struct.pack("<I", 4 + 26 + 12 + 8 + len(data))
                + b"WAVE"
                + b"fmt " + struct.pack("<IHHIIHH", 18, 3, 1, sr, sr * 4,
                                        4, 32) + b"\x00\x00"
                + b"fact" + struct.pack("<II", 4, len(x))
                + b"data" + struct.pack("<I", len(data)) + data)
    buf = io.BytesIO()
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2")
    with wave_mod.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return buf.getvalue()


class ShardWriter:
    """Streams cuts into cuts.NNNNNN.jsonl.gz + recording.NNNNNN.tar pairs.

    `fields` beyond "recording" open parallel tars (noise.NNNNNN.tar,
    echo.NNNNNN.tar, ...) whose members stay in recording order — the
    lhotse-shar alignment contract the reader consumes
    (data/shard.py ShardSource fields=...). Such cuts
    carry the arrays in cut["extras"][field]; an optional cut["sup"] dict
    is written as the first supervision's custom payload (reference
    test-set builder stores per-cut SNR/SER/dbFS there,
    scripts/data/shard_test.py:131-196)."""

    def __init__(self, out_dir: str, shard_size: int = 1000,
                 fields: tp.Sequence[str] = ("recording",)):
        self.out_dir = out_dir
        self.shard_size = shard_size
        self.fields = tuple(fields)
        os.makedirs(out_dir, exist_ok=True)
        self.shard_idx = 0
        self.written = 0
        self.total_sec = 0.0
        self._tars: tp.Dict[str, tarfile.TarFile] = {}
        self._metas: tp.List[dict] = []

    def write(self, cut: Cut) -> None:
        if not self._tars:
            self._tars = {
                f: tarfile.open(os.path.join(
                    self.out_dir, f"{f}.{self.shard_idx:06d}.tar"), "w")
                for f in self.fields}
        audio = np.asarray(cut["audio"], np.float32)
        sr = int(cut["sr"])
        meta = {"id": cut["id"], "duration": len(audio) / sr}
        if cut.get("custom"):
            meta["custom"] = cut["custom"]
        if cut.get("sup") is not None:
            meta["supervisions"] = [{
                "id": cut["id"], "recording_id": cut["id"], "start": 0,
                "duration": meta["duration"], "custom": cut["sup"]}]
        payloads = {"recording": audio}
        payloads.update(cut.get("extras") or {})
        float_fields = set(cut.get("float_fields") or ("rir",))
        for field, tar in self._tars.items():
            data = wav_bytes(np.asarray(payloads[field], np.float32), sr,
                             float32=field in float_fields)
            info = tarfile.TarInfo(f"{cut['id']}.wav")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        self._metas.append(meta)
        self.written += 1
        self.total_sec += meta["duration"]
        if self.written % self.shard_size == 0:
            self._flush()

    def _flush(self) -> None:
        if not self._tars:
            return
        for tar in self._tars.values():
            tar.close()
        with gzip.open(os.path.join(
                self.out_dir,
                f"cuts.{self.shard_idx:06d}.jsonl.gz"), "wt") as f:
            for m in self._metas:
                # allow_nan=False: non-finite floats would serialize as the
                # non-standard Infinity/NaN tokens and break strict-JSON
                # consumers of the shard (jq, orjson); fail at build time
                f.write(json.dumps(m, allow_nan=False) + "\n")
        self.shard_idx += 1
        self._tars = {}
        self._metas = []

    def close(self) -> str:
        self._flush()
        h, rem = divmod(int(self.total_sec), 3600)
        desc = (f"{self.written} cuts, {self.total_sec:.1f}s "
                f"({h}h{rem // 60:02d}m) across {self.shard_idx} shards")
        return desc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_adapter(
    jobs: tp.Sequence,
    process_one: tp.Callable[[tp.Any], tp.Union[tp.List[Cut], str]],
    out_dir: str,
    name: str,
    shard_size: int = 1000,
    num_jobs: int = 1,
    force: bool = False,
    fields: tp.Sequence[str] = ("recording",),
    initializer: tp.Optional[tp.Callable] = None,
    initargs: tp.Sequence = (),
    chunksize: int = 4,
) -> tp.Optional[str]:
    """Pool-process `jobs` with `process_one` (returns cuts, or an error/skip
    string) and stream results into `out_dir/name`. Writes a `.{name}.done`
    marker like the reference (:198-207); returns the summary, or None when
    the marker exists and force is False. `initializer(*initargs)` runs once
    per worker (and once in-process when num_jobs == 1) for adapters with
    per-worker sampler state (shard_test). `chunksize` sizes the pool's
    work batches when num_jobs > 1."""
    root = os.path.join(out_dir, name)
    done = os.path.join(out_dir, f".{name}.done")
    if os.path.exists(done):
        if not force:
            print(f"{name}: previous shards found; use --force to overwrite")
            return None
    import shutil

    # no marker + existing dir means a previous run crashed mid-write;
    # stale cuts.NNNNNN shards would otherwise survive and contaminate
    # this rerun (the reader globs cuts.*), so always start clean — and
    # drop any stale marker so a crash during THIS run isn't mistaken
    # for a completed build next time
    shutil.rmtree(root, ignore_errors=True)
    if os.path.exists(done):
        os.remove(done)
    n = 0
    with ShardWriter(root, shard_size, fields=fields) as writer:
        if num_jobs > 1:
            pool = ProcessPoolExecutor(
                num_jobs, mp_context=multiprocessing.get_context("spawn"),
                initializer=initializer, initargs=tuple(initargs))
            results = pool.map(process_one, jobs, chunksize=chunksize)
        else:
            if initializer is not None:
                initializer(*initargs)
            results = map(process_one, jobs)
        for res in results:
            if isinstance(res, str):
                print(res)
            else:
                for cut in res:
                    writer.write(cut)
            n += 1
            if n % 20 == 0:
                print(f"\r{n}/{len(jobs)}", end="", flush=True)
        if num_jobs > 1:
            pool.shutdown()
        desc = writer.close()
    with open(done, "w") as f:
        f.write(desc + "\n")
    print(f"\n{name}: {desc} -> {root}")
    return desc
