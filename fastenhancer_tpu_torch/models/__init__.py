"""Model registry: `get_model(name, **model_kwargs)`.

Every name of the JAX package's registry (fastenhancer_tpu/models/
__init__.py): the FastEnhancer models (the default, its conv_stft variant,
its dptransformer, dprnn, ln and time_kernel ablations, and the offline
noncausal variant) and the BSRNN, FSPEN and LiSenNet baselines.
"""
import typing as tp

from . import bsrnn as _bsrnn
from . import fspen as _fspen
from . import lisennet as _lisennet
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
    "fspen": _fspen.Model,
    "lisennet": _lisennet.Model,
}


def get_model_class(name: str) -> tp.Type:
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; the port has "
                         f"{sorted(_MODELS)}")
    return _MODELS[name]


def get_model(name: str, **model_kwargs):
    return get_model_class(name)(**model_kwargs)


__all__ = ["get_model", "get_model_class"]
