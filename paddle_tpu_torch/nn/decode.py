"""Beam-search decoding over a cell (counterpart of paddle_tpu/nn/decode.py:
``BeamSearchDecoder`` and ``dynamic_decode``).

The reference ranks and reorders on the host in numpy. Here the scores,
the selection, the ``finished`` flags and the state reorder stay on the
states' device: a step reads one flag back (whether every beam has
finished) and the ids stay on the device to the end, where
``F.gather_tree`` backtracks them there.

States are nested tuples and lists of tensors, mapped leaf by leaf: a
cell whose state holds objects (a ``MultiHeadAttention.Cache``) hands
their tensors over as tuples and rebuilds the objects inside its
``forward``, as in the reference.
"""
import collections

import torch

from . import functional as F

__all__ = ["BeamSearchDecoder", "dynamic_decode"]

BeamSearchOutput = collections.namedtuple(
    "BeamSearchOutput", ["predicted_ids", "scores", "parent_ids"])


class BeamSearchDecoder:
    """``cell``: ``forward(inputs, states) -> (out, new_states)``;
    ``embedding_fn`` maps [batch * beam] int64 ids to the cell's inputs
    (the ids themselves when None); ``output_fn`` maps the cell's output
    to [batch * beam, vocab] logits (the output itself when None)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B*beam, ...] by repeating each batch row."""
        return x.repeat_interleave(beam_size, dim=0)

    def _step(self, ids, states):
        """One cell step over [B*beam] token ids -> (logits, new states)."""
        inputs = self.embedding_fn(ids) if self.embedding_fn is not None else ids
        out, new_states = self.cell(inputs, states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        return logits, new_states


def _map_states(states, fn):
    if isinstance(states, (tuple, list)):
        return type(states)(_map_states(s, fn) for s in states)
    return fn(states)


def _logsumexp(x):
    m = x.amax(dim=-1, keepdim=True)
    return m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True))


def dynamic_decode(decoder, inits=None, max_step_num=None, output_time_major=False,
                   impute_finished=False, is_test=False, return_length=False, **kwargs):
    """Runs ``decoder`` for at most ``max_step_num`` steps, or until every
    beam has emitted ``end_token``. Returns (BeamSearchOutput, final
    states), plus the lengths when ``return_length``:

    - ``predicted_ids`` int64 [B, T, beam] ([T, B, beam] when
      ``output_time_major``), backtracked by ``gather_tree``;
    - ``scores`` float32 [B, beam], each beam's summed log-probability;
    - ``parent_ids`` int64 [T, B, beam];
    - the states after the last step's reorder;
    - lengths int64 [B, beam]: the first ``end_token``'s step + 1, else T.

    Beam 0 starts at score 0 and the others at -1e9, so the first step
    draws every beam from beam 0; a finished beam extends only with
    ``end_token``, at no cost; each step keeps the ``beam`` best of the
    [B, beam * vocab] candidates and reorders the states by ``b * beam +
    parent``. ``impute_finished`` and ``is_test`` are accepted and unused,
    as in the reference."""
    if max_step_num is None:
        raise ValueError("max_step_num is required")
    beam = decoder.beam_size
    leaves = []
    _map_states(inits, leaves.append)
    if not leaves:
        raise ValueError("inits (initial cell states) are required")
    batch, device = leaves[0].shape[0], leaves[0].device

    states = _map_states(inits, lambda s: s.repeat_interleave(beam, dim=0))
    scores = torch.full((batch, beam), -1e9, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    ids = torch.full((batch * beam,), decoder.start_token, dtype=torch.int64, device=device)
    finished = torch.zeros((batch, beam), dtype=torch.bool, device=device)
    rows = torch.arange(batch, device=device)[:, None] * beam

    step_ids, step_parents = [], []
    eos_only = None
    for _ in range(int(max_step_num)):
        logits, new_states = decoder._step(ids, states)
        logp = logits - _logsumexp(logits)  # [B*beam, V]
        V = logp.shape[-1]
        logp = logp.reshape(batch, beam, V)
        if eos_only is None:
            eos_only = torch.full((V,), -1e9, dtype=torch.float32, device=device)
            eos_only[decoder.end_token] = 0.0
        logp = torch.where(finished[:, :, None], eos_only, logp)
        flat = (scores[:, :, None] + logp).reshape(batch, beam * V)
        scores, top = torch.topk(flat, beam, dim=1)
        parents = top // V
        tokens = top % V
        finished = torch.gather(finished, 1, parents) | (tokens == decoder.end_token)
        gather = (rows + parents).reshape(-1)
        states = _map_states(new_states, lambda s: s.index_select(0, gather))
        ids = tokens.reshape(-1)
        step_ids.append(tokens)
        step_parents.append(parents)
        if bool(finished.all()):
            break

    ids_t = torch.stack(step_ids)  # [T, B, beam]
    parents_t = torch.stack(step_parents)
    final = F.gather_tree(ids_t, parents_t)
    out = BeamSearchOutput(final if output_time_major else final.transpose(0, 1),
                           scores, parents_t)
    if not return_length:
        return out, states
    is_eos = final == decoder.end_token
    first = torch.where(is_eos.any(dim=0), is_eos.to(torch.uint8).argmax(dim=0) + 1,
                        final.shape[0])
    return out, states, first
