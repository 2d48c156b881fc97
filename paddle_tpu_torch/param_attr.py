"""ParamAttr / WeightNormParamAttr
(reference: python/paddle/fluid/param_attr.py). Port of
``paddle_tpu/param_attr.py``, unchanged but for its imports."""


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return None
        if arg is True:
            return ParamAttr()
        from paddle_tpu_torch.initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError("Unsupported param attr: %r" % (arg,))


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 gradient_clip=None, do_model_average=False):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         gradient_clip=gradient_clip,
                         do_model_average=do_model_average)
        self.dim = dim
