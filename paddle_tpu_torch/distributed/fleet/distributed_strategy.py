"""DistributedStrategy (counterpart of
paddle_tpu/distributed/fleet/distributed_strategy.py; reference: python/paddle/distributed/fleet/base/
distributed_strategy.py wrapping framework/distributed_strategy.proto:146-193
— amp/recompute/dgc/gradient_merge/lars/lamb/pipeline/sharding/
tensor_parallel/a_sync flags + config submessages). Same knob names,
dict-backed instead of protobuf."""
import copy


_DEFAULTS = {
    "amp": False,
    "amp_configs": {"init_loss_scaling": 32768.0, "custom_white_list": [],
                    "custom_black_list": [], "use_pure_fp16": False,
                    "use_bf16": True},
    "recompute": False,
    "recompute_configs": {"checkpoints": []},
    "pipeline": False,
    "pipeline_configs": {"accumulate_steps": 1, "micro_batch_size": 1},
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1},
    "sharding": False,
    "sharding_configs": {"segment_broadcast_MB": 32.0, "sharding_degree": 1,
                         "gradient_merge_acc_step": 1, "offload": False},
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "lars": False,
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                     "epsilon": 0.0, "exclude_from_weight_decay": []},
    "lamb": False,
    "lamb_configs": {"lamb_weight_decay": 0.01, "exclude_from_weight_decay": []},
    "dgc": False,
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1, "sparsity": [0.999]},
    "localsgd": False,
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "adaptive_localsgd": False,
    "adaptive_localsgd_configs": {"init_k_steps": 1, "begin_step": 1},
    "a_sync": False,
    "a_sync_configs": {"k_steps": -1, "max_merge_var_num": 1,
                       "send_queue_size": 16, "independent_recv_thread": False,
                       "geo_sgd_mode": False, "geo_sgd_need_push_nums": 100},
    "elastic": False,
    "auto": False,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "nccl_comm_num": 1,
    "sync_nccl_allreduce": True,
    "cudnn_exhaustive_search": False,
    "conv_workspace_size_limit": 512,
    "cudnn_batchnorm_spatial_persistent": False,
    "hybrid_configs": {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1, "sep_degree": 1,
                       "sharding_degree": 1},
    "heter_ccl_mode": False,
    "find_unused_parameters": False,
    "last_comm_group_size_MB": 1,
    "without_graph_optimization": False,
    "fp16_allreduce": False,
    "qat": False,
}


class DistributedStrategy:
    def __init__(self):
        self.__dict__["_cfg"] = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        cfg = self.__dict__["_cfg"]
        if name in cfg:
            return cfg[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        cfg = self.__dict__["_cfg"]
        if name.endswith("_configs") and name in cfg and isinstance(value, dict):
            cfg[name].update(value)
        else:
            cfg[name] = value

    def to_dict(self):
        return copy.deepcopy(self.__dict__["_cfg"])

    def __repr__(self):
        on = [k for k, v in self.__dict__["_cfg"].items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"
