"""ParamAttr (counterpart of paddle_tpu/framework/param_attr.py): how a
layer creates one of its parameters (``Layer.create_parameter``)."""


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> the defaults; a ParamAttr as it is; a string names the
        parameter; False -> no parameter; an initializer -> a ParamAttr
        with it."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        return ParamAttr(initializer=attr)


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
