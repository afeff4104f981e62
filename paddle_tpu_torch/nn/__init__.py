"""Layers and functional ops of the port (counterpart of paddle_tpu.nn)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import Layer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,  # noqa: F401
                   clip_by_norm, clip_grad_norm_)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .layers import *  # noqa: F401,F403
from .layers.container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from . import utils  # noqa: F401
from .utils import spectral_norm  # noqa: F401
from ..framework.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
