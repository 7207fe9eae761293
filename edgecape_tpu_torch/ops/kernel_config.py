"""Kernel-variant switches of the port; counterpart of the variant
switches of edgecape_tpu/ops/pallas_config.py.

Two eval paths exist in two forms, and which form runs is a measured
decision, not one of correctness:

* `decoder_stack`: the whole refinement decoder with its glue as one op
  (ops/fused_decoder.fused_decoder_stack) instead of one
  fused_decoder_layer per layer with the glue in PyTorch between them
  (tolerance-equal);
* `vit_pair_blocks`: the backbone as fused_vit_block2 over pairs of
  blocks instead of one fused_vit_block per block (bit-equal).

Precedence, the same as the JAX package's:

1. an explicit `set_<name>(bool)` override in the process,
2. the environment variable (`EDGECAPE_DEC_STACK`, `EDGECAPE_VIT_PAIR`;
   "0", "false" and "False" are off, anything else on),
3. the measured-defaults file: `hopper_tuned.json` at the repository
   root, or the path in `EDGECAPE_TORCH_TUNED`. It holds this card's A/B
   ratios (with the card's name and power limit) and the settings they
   gave at the threshold 1.02. The JAX package's `pallas_tuned.json`
   holds TPU measurements and is never read here,
4. False: the per-layer and per-block forms.

The switches are read when a forward is called, not when a module is
imported, so they can be flipped between two calls.

Widths are checked once, when a model is built for a CUDA device with
its fused ops on (`require_widths`): where the hand-written kernels of
an op the model will launch do not take its widths (ops/kernels.py
width_misfits: another d_model, nhead, ViT width, key count), the build
raises, naming each op and the width, so that no forward pass raises
half way. Which ops a model launches follows its configuration: the
trunk runs fused_vit_block at bf16 compute and flash_mha at fp32
(models/dinov2.py fused_ops). Any image size is taken (the key count
follows it; long rows go to the streaming attention kernels), and any
head width up to 512 channels, above it (the split route) channels and
a hidden in multiples of 8: what is refused is a trunk's channels, a
head dim above 128, more than 16 heads with the Markov bias or a split
width of no multiple of 8, each named with the plan's reason. use_flash=False builds
the plain modules, which take any width. On the CPU an op takes
its plain version, so nothing is checked there. There is no
interpret switch (a CUDA kernel has nothing to interpret: on a CPU
tensor an op takes its plain version), and no `encoder_stack` switch:
the port has one form of the encoder stack, fused_encoder_stack, which
is the layer op applied per layer.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

THRESHOLD = 1.02      # a variant is switched on when its A/B ratio exceeds it

_TUNED: Optional[Dict[str, bool]] = None
_OVERRIDES: Dict[str, Optional[bool]] = {}


def tuned_path() -> str:
    """Location of the measured-defaults file."""
    env = os.environ.get("EDGECAPE_TORCH_TUNED")
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "hopper_tuned.json")


def _tuned() -> Dict[str, bool]:
    global _TUNED
    if _TUNED is None:
        try:
            with open(tuned_path()) as f:
                data = json.load(f)
            _TUNED = {k: bool(v) for k, v in
                      data.get("switches", {}).items()}
        except (OSError, ValueError):
            _TUNED = {}
    return _TUNED


def reload_tuned() -> None:
    """Drop the cached measured-defaults file (after writing a new one)."""
    global _TUNED
    _TUNED = None


def _switch(name: str, env_var: str) -> bool:
    ov = _OVERRIDES.get(name)
    if ov is not None:
        return ov
    env = os.environ.get(env_var)
    if env is not None:
        return env not in ("0", "false", "False")
    tuned = _tuned().get(name)
    if tuned is not None:
        return tuned
    return False


def set_decoder_stack(value: Optional[bool]) -> None:
    """Override the whole-decoder-as-one-op path (None = default)."""
    _OVERRIDES["decoder_stack"] = value


def decoder_stack_default() -> bool:
    """True when the eval path runs the decoder through
    fused_decoder_stack. Env: EDGECAPE_DEC_STACK."""
    return _switch("decoder_stack", "EDGECAPE_DEC_STACK")


def set_vit_pair_blocks(value: Optional[bool]) -> None:
    """Override the two-blocks-per-op backbone path (None = default)."""
    _OVERRIDES["vit_pair_blocks"] = value


def vit_pair_blocks_default() -> bool:
    """True when the fused backbone runs fused_vit_block2 over pairs of
    blocks. Env: EDGECAPE_VIT_PAIR."""
    return _switch("vit_pair_blocks", "EDGECAPE_VIT_PAIR")


def require_widths(ops: Iterable[str], misfits: dict, device,
                   switch: str = "use_flash=False") -> None:
    """Raises ValueError when a model built for `device` with its fused
    ops on has widths their kernels do not take: on a CUDA device, each op
    of `ops` whose entry in `misfits` (ops/kernels.py width_misfits) is not
    None, named with the reason, and the `switch` that builds the plain
    modules instead. Nothing is checked for the CPU."""
    if device is None or not str(device).startswith("cuda"):
        return
    bad = [f"{op} ({misfits[op]})" for op in ops if misfits.get(op)]
    if bad:
        raise ValueError(
            "the hand-written kernels do not take this model's widths: "
            + "; ".join(bad) + f"; {switch} builds the plain modules")
