"""Hand-written Hopper kernels of the port, one module per TPU kernel of
``hetu_tpu/ops/pallas/`` (CUDA sources under ``hetu_tpu_torch/csrc/``).

Importing these modules builds nothing: a kernel is built (``nvcc``) or
compiled (Triton) on its first launch.
"""


def _counters():
    from . import flash_attention as fa
    from . import moe_dispatch, softmax_ce, sparse_densify
    return ((fa.dropout_keep_mask, fa.flash_attention_fwd,
             fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
             fa.flash_attention_block, fa.flash_attention_block_bwd_dq,
             fa.flash_attention_block_bwd_dkv, softmax_ce.softmax_ce_fwd,
             softmax_ce.softmax_ce_bwd, sparse_densify.pack_write_kernel,
             moe_dispatch.row_gather_kernel), fa.route_launches)


def launch_counts():
    """Every launch counter: {wrapper: its ``launches``, (kernel, route):
    ``flash_attention.route_launches``'s count}."""
    fns, routes = _counters()
    return {**{fn: fn.launches for fn in fns}, **routes}


def restore_launches(counts):
    """Set every counter back to a ``launch_counts`` snapshot (a CUDA
    graph's capture runs the wrappers but launches nothing)."""
    fns, routes = _counters()
    for fn in fns:
        fn.launches = counts[fn]
    routes.clear()
    routes.update({k: n for k, n in counts.items() if isinstance(k, tuple)})


def add_launches(delta):
    """Add {counter: n}, keyed as ``launch_counts``, to the counters.  A
    CUDA graph's replay launches the kernels its capture counted, and the
    executor adds those counts once a replay (the wrappers do not run)."""
    _, routes = _counters()
    for key, n in delta.items():
        if isinstance(key, tuple):
            routes[key] += n
        else:
            key.launches += n
