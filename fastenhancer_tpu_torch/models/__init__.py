"""Model registry: `get_model(name, **model_kwargs)`.

The port has every FastEnhancer model (the default, its conv_stft variant,
its dptransformer, dprnn, ln and time_kernel ablations, and the offline
noncausal variant) and the BSRNN baseline; the other names of the JAX
package's registry (fastenhancer_tpu/models/__init__.py), fspen and
lisennet, raise NotImplementedError until their port lands (ROADMAP queue
1, "The baselines").
"""
import typing as tp

from . import bsrnn as _bsrnn
from .fastenhancer import conv_stft as _fastenhancer_conv_stft
from .fastenhancer import default as _fastenhancer_default
from .fastenhancer import dprnn as _fastenhancer_dprnn
from .fastenhancer import dptransformer as _fastenhancer_dptransformer
from .fastenhancer import ln as _fastenhancer_ln
from .fastenhancer import noncausal as _fastenhancer_noncausal
from .fastenhancer import time_kernel as _fastenhancer_time_kernel

_MODELS = {
    "fastenhancer.default": _fastenhancer_default.Model,
    "fastenhancer.dptransformer": _fastenhancer_dptransformer.Model,
    "fastenhancer.dprnn": _fastenhancer_dprnn.Model,
    "fastenhancer.ln": _fastenhancer_ln.Model,
    "fastenhancer.time_kernel": _fastenhancer_time_kernel.Model,
    "fastenhancer.conv_stft": _fastenhancer_conv_stft.Model,
    "fastenhancer.noncausal": _fastenhancer_noncausal.Model,
    "bsrnn": _bsrnn.Model,
}


def get_model_class(name: str) -> tp.Type:
    if name not in _MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP queue 1); "
            f"the port has {sorted(_MODELS)}")
    return _MODELS[name]


def get_model(name: str, **model_kwargs):
    return get_model_class(name)(**model_kwargs)


__all__ = ["get_model", "get_model_class"]
