"""Processes for tests/test_torch_serving_mesh.py.

Modes (argv[1]):

  reference OUT INPUTS
      The JAX package's meshed engines, in a process whose jax has 4 CPU
      devices (``tests/sharded_worker.py`` sets the flag before jax
      starts; the tier-1 parent has one device). The reference's four toy
      models (``sharded_worker.build_models``) run INPUTS' requests
      (``{dtype}_{i}`` arrays) through a BatchingEngine of each mesh
      ("single", "tp2", "fsdp2xtp2"), then the reference's toy decode
      model decodes one prompt under "tp2". Writes ``OUT.npz`` (the
      replies ``{mesh}_{dtype}_{i}`` and the f32 MLP's weights
      ``w_{name}``) and ``OUT.json`` (each mesh's stats' mesh, and the
      compile ledger's events: key, kind and tags).

  rank OUT MESH INPUTS PREFIX [PREFIX ...]
      One rank of a launcher job of MESH's shard count (gloo, the CPU):
      first, with the current place left at the card, the engine must
      refuse the mesh (no card here); then on ``set_device("cpu")``, for
      each saved program, the port's BatchingEngine under MESH, which
      the rank backing serves (each rank holds its own blocks), runs
      INPUTS' requests for it (``{j}_...`` for the j-th prefix) in
      lockstep; rank 0 writes ``OUT/rank0.npz`` and ``OUT/rank0.json``.
      Imports nothing of jax or the JAX package.
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = ("single", "tp2", "fsdp2xtp2")
LEDGER_FIELDS = ("key", "kind", "bucket", "phase", "mesh", "quant")


def _events(ledger, prefix):
    return [{k: e.get(k) for k in LEDGER_FIELDS} for e in ledger.events(prefix)]


def run_reference(out, inputs_path):
    sys.path.insert(0, HERE)
    import sharded_worker

    os.environ["SHARDED_WORKER_DEVICES"] = "4"
    sharded_worker._setup_devices()
    from decode_worker import toy_decode_model
    from paddle_tpu.inference.batching import BatchingEngine
    from paddle_tpu.inference.decode import DecodeEngine
    from paddle_tpu.jit import load as jit_load
    from paddle_tpu.obs.ledger import LEDGER

    inputs = dict(np.load(inputs_path))
    prefixes = sharded_worker.build_models()
    arrays, record = {}, {"stats_mesh": {}, "serving": {}, "totals_keys": None}
    layer = jit_load(prefixes["f32"])
    for name, p in layer._parameters.items():
        arrays[f"w_{p.name if hasattr(p, 'name') else name}"] = np.asarray(p._value)
    record["weight_names"] = [getattr(p, "name", n) for n, p in layer._parameters.items()]
    for mesh in MESHES:
        LEDGER.reset()
        for name in prefixes:
            eng = BatchingEngine.for_layer(jit_load(prefixes[name]), max_batch_size=4,
                                           watchdog_interval=0, mesh=mesh,
                                           name=f"{mesh}-{name}")
            eng.warmup()
            i = 0
            while f"{name}_{i}" in inputs:
                arrays[f"{mesh}_{name}_{i}"] = eng.infer([inputs[f"{name}_{i}"]],
                                                         timeout=240)[0]
                i += 1
            record["stats_mesh"][f"{mesh}_{name}"] = eng.stats()["mesh"]
            eng.close()
        record["serving"][mesh] = _events(LEDGER, "serving/")
    record["event_keys"] = sorted(LEDGER.events()[0])
    record["totals_keys"] = sorted(LEDGER.totals("serving/"))
    LEDGER.reset()
    eng = DecodeEngine(toy_decode_model(hidden=32, vocab=64, seed=0), max_slots=4,
                       max_seq_len=32, min_seq_bucket=8, watchdog_interval=0, mesh="tp2",
                       name="ref-decode-tp2")
    try:
        arrays["decode_tp2"] = eng.generate(np.array([3, 1, 4, 1, 5], np.int32),
                                            max_new_tokens=6, timeout=240)
        record["decode_stats_mesh"] = eng.stats()["mesh"]
    finally:
        eng.close()
    record["decode"] = _events(LEDGER, "decode/")
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(record, f)


def run_rank(out, mesh, inputs_path, prefixes):
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(HERE))
    import paddle_tpu_torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.inference.batching import BatchingEngine
    from paddle_tpu_torch.jit import load as jit_load

    dist.init_parallel_env()
    rank = dist.get_rank()
    inputs = dict(np.load(inputs_path))
    replies, record = {}, {"world": dist.get_world_size(), "programs": []}
    if not torch.cuda.is_available():
        # the current place is the card until set_device says otherwise: a
        # rank with no card must refuse the mesh, never serve on the CPU
        try:
            BatchingEngine.for_layer(jit_load(prefixes[0], device="cpu"), mesh=mesh,
                                     watchdog_interval=0, name=f"rank{rank}-nocard").close()
            record["no_card"] = None
        except RuntimeError as e:
            record["no_card"] = str(e)
    paddle_tpu_torch.set_device("cpu")
    for j, prefix in enumerate(prefixes):
        engine = BatchingEngine.for_layer(jit_load(prefix, device="cpu"), max_batch_size=4,
                                          watchdog_interval=0, mesh=mesh, name=f"rank{rank}-{j}")
        try:
            engine.warmup()
            # one request at a time, in the same order on every rank: the
            # collectives of each product meet in lockstep
            for key in sorted(k for k in inputs if k.startswith(f"{j}_")):
                for i, out_ in enumerate(engine.infer([inputs[key]], timeout=240)):
                    replies[f"{key}_{i}"] = out_
            record["programs"].append({
                "mesh": engine.stats()["mesh"], "devices": engine._runner.mesh_devices,
                "blocks": [[type(w).__name__, len(getattr(w, "blocks", ()))]
                           for w in engine._runner._layer._weights]})
        finally:
            engine.close()
    if rank == 0:
        np.savez(os.path.join(out, "rank0.npz"), **replies)
        with open(os.path.join(out, "rank0.json"), "w") as f:
            json.dump(record, f)


def main():
    mode = sys.argv[1]
    if mode == "reference":
        run_reference(sys.argv[2], sys.argv[3])
    elif mode == "rank":
        run_rank(sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5:])
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
