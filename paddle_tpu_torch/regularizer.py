"""Regularizers (counterpart of paddle_tpu/regularizer.py:1-17).

An optimizer's ``weight_decay`` or a parameter's ``regularizer``
attribute: ``L2Decay`` adds ``coeff * param`` to the gradient,
``L1Decay`` adds ``coeff * sign(param)`` (optimizer/optimizer.py
``_hypers`` and ``_take_l1``)."""


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self.coeff = self._coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self.coeff = self._coeff


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay
