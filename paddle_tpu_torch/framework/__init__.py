"""paddle.framework (counterpart of paddle_tpu/framework): ParamAttr."""
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
