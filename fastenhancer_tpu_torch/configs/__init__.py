from .builder import build_all, deep_merge, fe_model_kwargs, FE_SIZES

__all__ = ["build_all", "deep_merge", "fe_model_kwargs", "FE_SIZES"]
