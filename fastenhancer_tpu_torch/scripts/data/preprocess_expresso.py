"""Segment the Expresso corpus using its VAD annotation file.

The port's scripts/data/preprocess_expresso.py, mirroring the reference's
scripts/data/preprocess_expresso.py: `VAD_segments.txt` maps stems to
(start, end) speech intervals; conversational stereo files are downmixed
to mono with the union of both channels' VAD timelines, read/**/longform
files use their single timeline. VAD segments longer than --max-dur are
sub-split either into fixed-length chunks (tail kept if >= --tail-min) or
at the LAST energy-silence frame inside [--min-dur, --max-dur] (20 ms
frames, -40 dB of the segment's peak frame; note this differs from
segment_vad.py's first-silence forward search). Unsegmented read/ style
dirs are symlinked into the output tree.

    python -m fastenhancer_tpu_torch.scripts.data.preprocess_expresso \
        --dataset-root expresso/audio_48khz --vad-file \
        expresso/VAD_segments.txt --output-dir .../segmented
"""
import argparse
import os
import re
import sys

import numpy as np


def parse_vad_file(vad_path: str):
    """txt lines `key\\t(s1, e1), (s2, e2), ...` -> {key: [(s, e), ...]}."""
    vad = {}
    with open(vad_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, segments_str = line.split("\t", 1)
            vad[key] = [(float(s), float(e)) for s, e in re.findall(
                r"\(([0-9.]+),\s*([0-9.]+)\)", segments_str)]
    return vad


def merge_intervals(intervals):
    """Union-merge overlapping/adjacent (start, end) intervals."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    merged = [intervals[0]]
    for start, end in intervals[1:]:
        if start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def split_fixed(audio, sr, max_dur, tail_min):
    """Fixed max_dur chunks; tail shorter than tail_min dropped."""
    max_s, tail_s = int(max_dur * sr), int(tail_min * sr)
    chunks = []
    for off in range(0, len(audio), max_s):
        chunk = audio[off: off + max_s]
        if len(chunk) < tail_s:
            break
        chunks.append(chunk)
    return chunks


def split_vad_based(audio, sr, max_dur, min_dur, frame_ms=20):
    """Cut at the LAST silence frame in [min_dur, max_dur] from the current
    position (backward search, 20 ms frames, -40 dB of segment peak frame);
    force-cut at max_dur when none; final piece kept if >= 1 s."""
    frame = int(frame_ms / 1000 * sr)
    n_frames = max(1, len(audio) // frame)
    trimmed = audio[: n_frames * frame].astype(np.float64)
    rms = np.sqrt((trimmed.reshape(n_frames, frame) ** 2).mean(axis=1))
    peak = rms.max() if rms.max() > 0 else 1.0
    is_silence = rms < peak * 0.01
    max_s, min_s = int(max_dur * sr), int(min_dur * sr)
    chunks = []
    start = 0
    while start < len(audio):
        remaining = len(audio) - start
        if remaining <= max_s:
            chunk = audio[start:]
            if len(chunk) >= sr:  # keep if >= 1 s
                chunks.append(chunk)
            break
        lo = (start + min_s) // frame
        hi = min((start + max_s) // frame, n_frames - 1)
        win = np.nonzero(is_silence[lo: hi + 1])[0]
        cut = (lo + win[-1]) * frame if len(win) else start + max_s
        if cut > start:
            chunks.append(audio[start:cut])
        start = max(cut, start + 1)
    return chunks


def process_file(wav_path, vad_segments, output_dir, strategy, max_dur,
                 min_dur, tail_min):
    from ...data.audio_io import read_wav

    from .segment_vad import write_wav_any

    audio, sr = read_wav(wav_path)  # stereo downmixed to mono
    total_dur = len(audio) / sr
    segments = [(max(0.0, s), min(e, total_dur)) for s, e in vad_segments
                if e > 0 and s < total_dur]
    segments = [(s, e) for s, e in segments if e - s >= 0.1]
    if not segments:
        return 0
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(wav_path))[0]
    seg_idx = 0
    for seg_start, seg_end in segments:
        chunk = audio[int(seg_start * sr): int(seg_end * sr)]
        if len(chunk) / sr <= max_dur:
            subs = [chunk]
        elif strategy == "fixed":
            subs = split_fixed(chunk, sr, max_dur, tail_min)
        else:
            subs = split_vad_based(chunk, sr, max_dur, min_dur)
        for sub in subs:
            write_wav_any(os.path.join(
                output_dir, f"{stem}_{seg_idx:04d}.wav"), sub, sr, "pcm16")
            seg_idx += 1
    return seg_idx


def create_read_symlinks(output_dir: str, dataset_root: str) -> None:
    """Symlink unsegmented read/ style dirs into the output tree: style
    dirs with only base/ are linked whole; base/ + longform/ links only
    base/ (longform is what gets segmented); longform-only is skipped."""
    src_read = os.path.join(dataset_root, "read")
    if not os.path.isdir(src_read):
        return
    for speaker in sorted(os.listdir(src_read)):
        spk_dir = os.path.join(src_read, speaker)
        if not os.path.isdir(spk_dir):
            continue
        dst_spk = os.path.join(output_dir, "read", speaker)
        os.makedirs(dst_spk, exist_ok=True)
        for style in sorted(os.listdir(spk_dir)):
            style_dir = os.path.join(spk_dir, style)
            if not os.path.isdir(style_dir):
                continue
            has_base = os.path.isdir(os.path.join(style_dir, "base"))
            has_long = os.path.isdir(os.path.join(style_dir, "longform"))
            if has_base and not has_long:
                link = os.path.join(dst_spk, style)
                if not os.path.lexists(link):
                    os.symlink(style_dir, link)
                    print(f"  linked  read/{speaker}/{style}")
            elif has_base and has_long:
                os.makedirs(os.path.join(dst_spk, style), exist_ok=True)
                link = os.path.join(dst_spk, style, "base")
                if not os.path.lexists(link):
                    os.symlink(os.path.join(style_dir, "base"), link)
                    print(f"  linked  read/{speaker}/{style}/base")


def collect_files(vad, output_dir: str, dataset_root: str):
    import glob

    files = []
    for wav_path in sorted(glob.glob(os.path.join(
            dataset_root, "conversational", "**", "*.wav"), recursive=True)):
        stem = os.path.splitext(os.path.basename(wav_path))[0]
        merged = merge_intervals(vad.get(f"{stem}/channel1", [])
                                 + vad.get(f"{stem}/channel2", []))
        if not merged:
            print(f"WARNING: no VAD entry for {stem}", file=sys.stderr)
            continue
        rel = os.path.relpath(wav_path, dataset_root)
        files.append((wav_path, merged,
                      os.path.join(output_dir, os.path.dirname(rel))))
    for wav_path in sorted(glob.glob(os.path.join(
            dataset_root, "read", "**", "longform", "*.wav"),
            recursive=True)):
        stem = os.path.splitext(os.path.basename(wav_path))[0]
        segs = vad.get(stem, [])
        if not segs:
            print(f"WARNING: no VAD entry for {stem}", file=sys.stderr)
            continue
        rel = os.path.relpath(wav_path, dataset_root)
        files.append((wav_path, segs,
                      os.path.join(output_dir, os.path.dirname(rel))))
    return files


def main(argv=None):
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Segment Expresso long WAV files using VAD annotations")
    ap.add_argument("--strategy", choices=["fixed", "vad"], default="vad")
    ap.add_argument("--max-dur", type=float, default=10.0)
    ap.add_argument("--min-dur", type=float, default=5.0)
    ap.add_argument("--tail-min", type=float, default=1.0)
    ap.add_argument("--dataset-root", required=True)
    ap.add_argument("--vad-file", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    vad = parse_vad_file(args.vad_file)
    files = collect_files(vad, args.output_dir, args.dataset_root)
    print(f"Found {len(files)} files to process (strategy={args.strategy})")
    if args.dry_run:
        for wav_path, segs, out_dir in files:
            print(f"  {os.path.relpath(wav_path, args.dataset_root)} -> "
                  f"{out_dir} ({len(segs)} VAD segs)")
        return
    create_read_symlinks(args.output_dir, args.dataset_root)
    total = 0
    for wav_path, segs, out_dir in files:
        n = process_file(wav_path, segs, out_dir, args.strategy,
                         args.max_dur, args.min_dur, args.tail_min)
        print(f"  {os.path.basename(wav_path)}: {n} segments")
        total += n
    print(f"Done. {total} total segments written to {args.output_dir}")


if __name__ == "__main__":
    main()
