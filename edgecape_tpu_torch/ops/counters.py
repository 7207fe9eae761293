"""Launch counters of the kernel ops and their kernels, in one place: each
op module counts where it launches its kernels (a module attribute, named
in OP_COUNTERS), each kernel's wrapper in ops/kernels.py `launches` and
ops/mm_chain.py `launches`. The bench's phase children print them, and the
chip smoke zeroes and reads them around every path it drives."""

from __future__ import annotations

import importlib

from . import kernels, mm_chain

# (name, module of edgecape_tpu_torch.ops, attribute) of the op-level
# launch counters, with the TPU kernel each op ports
OP_COUNTERS = (
    ("fused_vit_block", "fused_vit_block", "launches"),              # 1
    ("fused_vit_block2", "fused_vit_block", "launches2"),            # 2
    ("fused_encoder_stack", "fused_encoder", "stack_launches"),      # 3
    ("fused_encoder_layer", "fused_encoder", "launches"),            # 3
    ("fused_decoder_layer", "fused_decoder", "launches"),            # 4
    ("fused_decoder_stack", "fused_decoder", "stack_launches"),      # 5
    ("flash_mha", "flash_attention", "launches"),                    # 6
    ("flash_mha_train_fwd", "flash_attention", "launches_fwd"),      # 7
    ("flash_mha_train_bwd", "flash_attention", "launches_bwd"),      # 8
    ("fused_ln_mlp", "fused_mlp", "launches"),                       # 9
    ("fused_attn_block", "fused_attn_block", "launches"))            # 10


# The streaming attention kernels (csrc/attn_long.cu), which the paths
# launch where a row is longer than the resident kernels hold (ViT above
# 272 tokens, any attention above 512 keys, at head dim 128 above 416):
# counted in kernels.launches like the rest, their head-dim-128 instances
# apart, named here for the paths that must (518 px) or must not (224 px)
# launch them.
LONG_KERNELS = ("attn_long_kernel", "train_fwd_long_kernel",
                "train_bwd_q_long_kernel", "train_bwd_k_long_kernel",
                "attn_long_kernel<128>", "train_fwd_long_kernel<128>",
                "train_bwd_q_long_kernel<128>",
                "train_bwd_k_long_kernel<128>")


def _module(name: str):
    return importlib.import_module("edgecape_tpu_torch.ops." + name)


def launch_counts() -> dict:
    """{"ops": every op-level counter, "kernels": the kernels launched so
    far (kernels.launch_counts, the non-zero ones)}."""
    return {"ops": {name: getattr(_module(mod), attr)
                    for name, mod, attr in OP_COUNTERS},
            "kernels": {k: v for k, v in kernels.launch_counts().items()
                        if v}}


def zero_counts() -> None:
    """Every op-level and kernel-level launch counter to 0."""
    for _, mod, attr in OP_COUNTERS:
        setattr(_module(mod), attr, 0)
    kernels.launches.update(dict.fromkeys(kernels.launches, 0))
    mm_chain.launches = 0
