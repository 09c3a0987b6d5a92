"""bluefog_tpu_torch: the PyTorch + CUDA port of bluefog_tpu.

``bluefog_tpu/`` (JAX on a TPU) stays as the reference; this package is its
port to PyTorch on an NVIDIA H100, slice by slice.  It imports neither jax
nor anything of ``bluefog_tpu``.  Entry points run on CUDA unless the caller
asks for the CPU, and raise when no GPU is present.

    import bluefog_tpu_torch as bf
    bf.init(4)                       # 4 virtual ranks on the GPU
    x = bf.dynamic_neighbor_allreduce(rank_major_tensor, step)

    bf.init_distributed()            # one process a card (bfrun, torchrun)
    x = bf.dynamic_neighbor_allreduce(owned_rows, step)

    bf.win_create(rows, "w")         # one-sided windows (rank-major rows,
    bf.win_put(rows, "w")            # or a process's owned rows across
    x = bf.win_update("w")           # processes)

The model-parallel names of ``parallel`` (tensor, pipeline and expert
parallelism: ``bf.pipeline_train_step``, ...) are exported here too, each
imported when first read.

Observability: ``bf.telemetry`` (the metric registry, ``/metrics`` and
``/healthz``), ``bf.telemetry_snapshot()``, ``bf.step_profile()``,
``bf.profiler``, the timeline (``BLUEFOG_TIMELINE``, ``bf.start_timeline``,
``bf.timeline_context``), ``bf.flight_recorder_dump()``, the link
observatory's matrix ``bf.link_report()`` and the put-plan path's
``bf.win_xla_info()``.

Elasticity (``BLUEFOG_TPU_CHURN``, ``BLUEFOG_TPU_ELASTIC_JOIN``): the churn
supervisor (``bluefog_tpu_torch.run.supervisor``, driven by the window
optimizers), ``bf.membership_info()``, the gang join and bootstrap
``bf.gang`` with ``bf.gang_info()``, checkpoints and the restartable run
loop (``utils.checkpoint``, ``utils.elastic``) and the input pipeline
``bf.data``.

Every name here is imported when first read, as ``parallel``'s are: the
package itself imports nothing, so that ``python -m
bluefog_tpu_torch.run`` (the launcher) and ``python -m
bluefog_tpu_torch.tools`` start without torch.
"""

import importlib
import importlib.util

# name -> (module, attribute in it; None for the module itself).
_EXPORTS = {"topology_util": ("topology", None), "data": ("data", None),
            "optim": ("optim", None), "gang": ("ops.gang", None),
            "profiler": ("utils.profiler", None),
            "telemetry": ("utils.telemetry", None),
            "flight_recorder_dump": ("utils.flightrec", "dump"),
            "link_report": ("utils.linkobs", "link_report"),
            "win_xla_info": ("ops.xlaffi", "info"),
            "step_profile": ("utils.profiler", "step_profile"),
            "telemetry_snapshot": ("utils.telemetry", "telemetry_snapshot"),
            "_window": ("ops.window", None)}
for _module, _names in (
        ("basics", """
    Handle allgather allgather_nonblocking allgather_v allreduce
    allreduce_nonblocking barrier broadcast broadcast_nonblocking
    broadcast_parameters device dynamic_neighbor_allreduce
    dynamic_neighbor_allreduce_nonblocking init init_distributed
    initialized is_homogeneous is_topo_weighted load_topology
    local_allreduce local_allreduce_nonblocking local_rank local_size
    machine_rank machine_size neighbor_allgather
    neighbor_allgather_nonblocking neighbor_allgather_v neighbor_allreduce
    neighbor_allreduce_nonblocking owned_ranks pair_gossip
    pair_gossip_nonblocking poll process_ranks rank set_topology
    shutdown size synchronize wait set_machine_topology
    load_machine_topology hierarchical_neighbor_allreduce
    hierarchical_neighbor_allreduce_nonblocking
    dynamic_hierarchical_neighbor_allreduce
    dynamic_hierarchical_neighbor_allreduce_nonblocking hierarchical_gossip
    hierarchical_gossip_nonblocking hierarchical_gossip_info suspend
    resume suspended in_neighbor_ranks out_neighbor_ranks
    in_neighbor_machine_ranks out_neighbor_machine_ranks
    allreduce_parameters broadcast_optimizer_state allreduce_
    allreduce_nonblocking_ broadcast_ broadcast_nonblocking_
    set_skip_negotiate_stage get_skip_negotiate_stage
    mpi_threads_supported nccl_built unified_mpi_window_model_supported
    placement_info synthesis_info membership_info gang_info"""),
        ("utils.timeline", """
    start_timeline stop_timeline timeline_context timeline_end_activity
    timeline_start_activity"""),
        ("ops.window", """
    get_current_created_window_names get_win_version win_accumulate
    win_accumulate_nonblocking win_associated_p win_create win_fence
    win_flush win_free win_get win_get_nonblocking win_load_state_dict
    win_mutex win_poll win_put win_put_nonblocking win_state_dict
    win_update win_update_then_collect win_wait
    turn_off_win_ops_with_associated_p turn_on_win_ops_with_associated_p
    async_info win_fold_stale_residuals"""),
        ("parallel", """
    load_balance_loss moe_apply pipeline_apply pipeline_train_step
    pipeline_train_step_interleaved switch_dispatch tp_param_specs
    tp_shard_params""")):
    _EXPORTS.update((_n, (_module, _n)) for _n in _names.split())

_ALL = ["topology_util", "init", "init_distributed", "shutdown", "barrier",
        "initialized", "size", "rank", "owned_ranks", "local_size",
        "local_rank", "machine_size", "machine_rank", "is_homogeneous",
        "process_ranks", "device", "set_topology", "load_topology",
        "is_topo_weighted", "allreduce", "local_allreduce", "broadcast",
        "allgather", "allgather_v", "neighbor_allreduce",
        "dynamic_neighbor_allreduce", "neighbor_allgather",
        "neighbor_allgather_v", "pair_gossip", "broadcast_parameters",
        "Handle", "allreduce_nonblocking", "local_allreduce_nonblocking",
        "broadcast_nonblocking", "allgather_nonblocking",
        "neighbor_allreduce_nonblocking",
        "dynamic_neighbor_allreduce_nonblocking",
        "neighbor_allgather_nonblocking", "pair_gossip_nonblocking",
        "poll", "wait", "synchronize", "set_machine_topology",
        "load_machine_topology", "hierarchical_neighbor_allreduce",
        "hierarchical_neighbor_allreduce_nonblocking",
        "dynamic_hierarchical_neighbor_allreduce",
        "dynamic_hierarchical_neighbor_allreduce_nonblocking",
        "hierarchical_gossip", "hierarchical_gossip_nonblocking",
        "hierarchical_gossip_info", "suspend", "resume", "suspended",
        "in_neighbor_ranks", "out_neighbor_ranks",
        "in_neighbor_machine_ranks", "out_neighbor_machine_ranks",
        "allreduce_parameters", "broadcast_optimizer_state", "allreduce_",
        "allreduce_nonblocking_", "broadcast_", "broadcast_nonblocking_",
        "set_skip_negotiate_stage", "get_skip_negotiate_stage",
        "mpi_threads_supported", "nccl_built",
        "unified_mpi_window_model_supported", "placement_info",
        "synthesis_info", "telemetry", "telemetry_snapshot", "profiler",
        "step_profile", "flight_recorder_dump", "start_timeline",
        "stop_timeline", "timeline_context", "timeline_start_activity",
        "timeline_end_activity", "link_report", "win_xla_info",
        "membership_info", "gang_info", "gang", "data"]


def __getattr__(name):
    if name == "__all__":
        # The window module's whole surface and parallel's names.
        value = (_ALL + importlib.import_module(f"{__name__}.ops.window")
                 .__all__ + importlib.import_module(f"{__name__}.parallel")
                 .__all__)
    elif name in _EXPORTS:
        module, attr = _EXPORTS[name]
        value = importlib.import_module(f"{__name__}.{module}")
        if attr is not None:
            value = getattr(value, attr)
    elif (not name.startswith("__")
          and importlib.util.find_spec(f"{__name__}.{name}") is not None):
        # A subpackage or module (``bf.ops``, ``bf.basics``, ...).
        value = importlib.import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
