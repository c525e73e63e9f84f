"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing this package builds nothing: the CUDA library is compiled on the
first launch (``_build.library``).
"""
from repro_torch.kernels.block_topk import block_topk
from repro_torch.kernels.fused_compress import (delta_pack, delta_pack_bf16,
                                                grid_quant_leaves)
from repro_torch.kernels.fused_update import (cffl_update, cffl_update_bf16,
                                              dsgld_update, fused_update,
                                              fused_update_bf16, gossip_mix)
from repro_torch.kernels.gilbert import gilbert_keep
from repro_torch.kernels.pack import (pack_topk, topk_select,
                                      topk_select_bf16, unpack_set,
                                      unpack_topk)
from repro_torch.kernels.qsgd import qsgd
from repro_torch.kernels.threefry import draw

WRAPPERS = {"pack": pack_topk, "delta_pack": delta_pack,
            "unpack": unpack_topk, "fused_update": fused_update,
            "grid_quant": grid_quant_leaves, "qsgd": qsgd,
            "block_topk": block_topk, "threefry": draw,
            "topk_select": topk_select, "unpack_set": unpack_set,
            "cffl_update": cffl_update, "dsgld_update": dsgld_update,
            "gossip_mix": gossip_mix, "gilbert_keep": gilbert_keep,
            # the forms that read bfloat16 control variates
            "topk_select_bf16": topk_select_bf16,
            "delta_pack_bf16": delta_pack_bf16,
            "fused_update_bf16": fused_update_bf16,
            "cffl_update_bf16": cffl_update_bf16}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
