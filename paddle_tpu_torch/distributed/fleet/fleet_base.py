"""Fleet facade, its collective half (counterpart of
paddle_tpu/distributed/fleet/fleet_base.py; reference:
fleet/base/fleet_base.py: init, worker_num, distributed_optimizer:661,
minimize:1161).

``fleet.init`` builds the hybrid topology from
``strategy.hybrid_configs`` (dp over every rank when they ask for one
rank), ``distributed_model`` wraps a model by the parallel mode
(``PipelineParallel`` for the pipe mode or ``strategy.pipeline``,
``ModelParallel`` for the model and hybrid modes, ``DataParallel``
otherwise), and ``distributed_optimizer`` returns the
``HybridParallelOptimizer`` with gradient merge. The parameter-server
runtime (``set_ps_tables``, ``init_server``, ``run_server``,
``stop_server``, ``init_worker``, ``ps_client``, ``stop_worker``) raises
NotImplementedError naming the slice that brings it.
"""
from ...optimizer import Optimizer
from .. import topology as topo_mod
from ..parallel import ParallelEnv, get_rank, get_world_size
from .distributed_strategy import DistributedStrategy

_PS = "the parameter-server slice (distributed/ps)"


class Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._is_collective = True
        self._util = None
        self._role_maker = None

    def init(self, role_maker=None, is_collective=False, strategy=None):
        self._strategy = strategy or DistributedStrategy()
        # a role maker constructed with is_collective=True keeps collective
        # semantics (reference: PaddleCloudRoleMaker(is_collective=True))
        self._is_collective = (is_collective or role_maker is None or
                               getattr(role_maker, "_is_collective", False))
        self._role_maker = None if self._is_collective else role_maker
        hc = self._strategy.hybrid_configs
        dp = hc.get("dp_degree", 1)
        mp = hc.get("mp_degree", 1)
        pp = hc.get("pp_degree", 1)
        sh = hc.get("sharding_degree", 1)
        sp = hc.get("sep_degree", hc.get("sp_degree", 1))
        if dp * mp * pp * sh * sp <= 1:
            dp, mp, pp, sh, sp = get_world_size(), 1, 1, 1, 1
        self._hcg = topo_mod.HybridCommunicateGroup(dp=dp, mp=mp, pp=pp, sharding=sh, sp=sp)
        topo_mod.set_hybrid_communicate_group(self._hcg)
        return self

    # --- role info (reference fleet_base) ---
    def worker_num(self):
        if self._role_maker is not None:
            return self._role_maker.worker_num()
        return get_world_size()

    def worker_index(self):
        if self._role_maker is not None:
            return self._role_maker.worker_index()
        return get_rank()

    def is_worker(self):
        if self._role_maker is not None:
            return self._role_maker.is_worker()
        return True

    def is_server(self):
        if self._role_maker is not None:
            return self._role_maker.is_server()
        return False

    def is_first_worker(self):
        if self._role_maker is not None:
            return self._role_maker.is_first_worker()
        return get_rank() == 0

    def worker_endpoints(self, to_string=False):
        eps = ParallelEnv().trainer_endpoints
        return ",".join(eps) if to_string else eps

    def server_num(self):
        if self._role_maker is not None:
            return self._role_maker.server_num()
        return 0

    # --- the parameter-server runtime: a later slice ---
    def set_ps_tables(self, table_configs):
        raise NotImplementedError(f"fleet.set_ps_tables: not ported yet ({_PS})")

    def init_server(self, *args, **kwargs):
        raise NotImplementedError(f"fleet.init_server: not ported yet ({_PS})")

    def run_server(self, block=False):
        raise NotImplementedError(f"fleet.run_server: not ported yet ({_PS})")

    def stop_server(self):
        raise NotImplementedError(f"fleet.stop_server: not ported yet ({_PS})")

    def init_worker(self, *args, **kwargs):
        raise NotImplementedError(f"fleet.init_worker: not ported yet ({_PS})")

    def ps_client(self):
        raise NotImplementedError(f"fleet.ps_client: not ported yet ({_PS})")

    def stop_worker(self):
        raise NotImplementedError(f"fleet.stop_worker: not ported yet ({_PS})")

    def barrier_worker(self):
        from ..collective import barrier

        barrier()

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def _user_defined_strategy(self):
        return self._strategy

    # --- model/optimizer wrapping ---
    def distributed_model(self, model):
        """reference: fleet_base.py distributed_model — picks the wrapper by
        parallel mode."""
        mode = self._hcg.get_parallel_mode() if self._hcg else "data"
        if mode == "pipe" or (self._strategy and self._strategy.pipeline):
            from ..meta_parallel import PipelineParallel

            return PipelineParallel(model, self._hcg, self._strategy)
        if mode in ("model", "hybrid"):
            from ..meta_parallel import ModelParallel

            return ModelParallel(model, self._hcg, self._strategy)
        from ..parallel import DataParallel

        return DataParallel(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        return HybridParallelOptimizer(optimizer, self._hcg, self._strategy)

    # legacy static-mode entry
    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        raise NotImplementedError(
            "static fleet.minimize: build the model in dygraph and use "
            "distributed_optimizer(...).minimize or distributed/spmd.py")


class HybridParallelOptimizer(Optimizer):
    """reference: fleet/meta_optimizers/dygraph_optimizer/
    hybrid_parallel_optimizer.py:84 — wraps the inner optimizer; the
    gradients are averaged by DataParallel.apply_collective_grads, so the
    wrapper adds gradient merge (fleet_base.py:213-255): with
    ``strategy.gradient_merge`` it steps every ``k_steps``-th call,
    the gradients accumulating in ``.grad`` between."""

    def __init__(self, inner, hcg=None, strategy=None):
        self._inner = inner
        self._hcg = hcg
        self._strategy = strategy
        self._merge_count = 0
        self._k_steps = 1
        if strategy is not None and strategy.gradient_merge:
            self._k_steps = strategy.gradient_merge_configs.get("k_steps", 1)

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def step(self):
        if self._k_steps > 1:
            self._merge_count += 1
            if self._merge_count < self._k_steps:
                return
            self._merge_count = 0
        self._inner.step()

    def minimize(self, loss, startup_program=None, parameters=None, no_grad_set=None):
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self, set_to_zero=True):
        if self._k_steps > 1 and self._merge_count != 0:
            return  # keep accumulating
        self._inner.clear_grad()

    clear_gradients = clear_grad


_fleet_singleton = Fleet()


def init(role_maker=None, is_collective=False, strategy=None):
    return _fleet_singleton.init(role_maker, is_collective, strategy)


def distributed_optimizer(optimizer, strategy=None):
    return _fleet_singleton.distributed_optimizer(optimizer, strategy)


def distributed_model(model):
    return _fleet_singleton.distributed_model(model)


def get_hybrid_communicate_group():
    return _fleet_singleton.get_hybrid_communicate_group()


def worker_num():
    return _fleet_singleton.worker_num()


def worker_index():
    return _fleet_singleton.worker_index()


def is_worker():
    return _fleet_singleton.is_worker()


def is_server():
    return _fleet_singleton.is_server()


def barrier_worker():
    return _fleet_singleton.barrier_worker()
