"""FastEnhancer's conv_stft variant: STFT and iSTFT as explicit DFT matmuls.

Counterpart of fastenhancer_tpu/models/fastenhancer/conv_stft.py. The
reference writes the front end as a conv1d with a DFT-matrix kernel so that
the exported ONNX graph has no FFT op (reference:
models/fastenhancer/conv_stft/model.py:55-153). Here that is the
`method="matmul"` mode of STFTConfig (functional/stft.py), so this variant
is the default model with the matmul front end. The network and its
parameters are the default model's.
"""
from __future__ import annotations

import dataclasses

from .default import Model as DefaultModel


class Model(DefaultModel):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stft_cfg = dataclasses.replace(self.stft_cfg, method="matmul")
