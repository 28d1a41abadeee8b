"""Corpus tools: raw corpora -> the lhotse-shar shards the shard recipe reads.

The port's scripts/data/. Each tool runs as
`python -m fastenhancer_tpu_torch.scripts.data.<name>` with the flags of
the JAX package's script of that name, and has `main(argv=None)`. They are
host code: no device is taken. Worker pools are spawned, not forked (a
fork of a process that has imported torch may copy a lock another thread
holds).

  shar_writer         ShardWriter, run_adapter (the shared harness)
  corpus_utils        the test-set builder's samplers
  shard_speech, shard_noise, shard_dns_rir, shard_wavdir, shard_test,
  shard_vctk, shard_demand, shard_hifitts1, shard_brudex, shard_myriad
                      corpus -> shards
  gen_brudex_csv, gen_myriad_csv
                      RIR CSVs for the test-set builder
  preprocess_brudex, preprocess_expresso, segment_vad, segment_daps,
  segment_ears        raw corpus -> wavs the builders read
"""
