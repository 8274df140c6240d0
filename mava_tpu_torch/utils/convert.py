"""Carry flax parameters over to the port's modules.

`from_flax_params(tree)` maps the parameter tree of a flax `FeedForwardActor`,
`FeedForwardValueNet`, `FeedForwardQNet`, `RecurrentActor`, `RecurrentValueNet`
or `RecQNetwork` (as numpy arrays, with or without the top-level "params" key) to a
`state_dict` of the port's module of the same name:

  * flax `Dense` kernels are (in, out); `nn.Linear.weight` is (out, in), so
    they are transposed;
  * a torso's flax children interleave (`Dense_0, LayerNorm_0, Dense_1, ...`,
    or `Conv_0, LayerNorm_0, Conv_1, ...`); `Dense_k` goes to `layers.k`,
    `Conv_k` to `convs.k` (its (kh, kw, in, out) kernel permuted to
    `Conv2d`'s (out, in, kh, kw)) and the bias of `LayerNorm_k` (it has no
    scale) to `norm_biases.k`;
  * the GRU's `wi` (F,3H), `bi` (3H), `wh` (H,3H) and `bhn` (H) keep their JAX
    layout, the layout the GRU kernel takes;
  * an action head's `Dense_0` is `action_head.linear`; the continuous head's
    log-std is its `Dense_1` (`action_head.log_std_linear`) or the parameter
    `log_std` (`action_head.log_std`);
  * a network's own last `Dense_0` is the critics' `value_head`, or the
    `q_head` of `RecQNetwork` and `FeedForwardQNet` when `head="q_head"`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _dense(prefix: str, dense: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": torch.as_tensor(np.asarray(dense["kernel"]).T.copy()),
        f"{prefix}.bias": torch.as_tensor(np.asarray(dense["bias"]).copy()),
    }


def from_flax_params(tree: Mapping[str, Any], head: str = "value_head") -> Dict[str, torch.Tensor]:
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if name == "ScannedRNN_0":
            for leaf in ("wi", "bi", "wh", "bhn"):
                out[f"rnn.{leaf}"] = torch.as_tensor(np.asarray(sub[leaf]).copy())
        elif name in ("torso", "pre_torso", "post_torso"):
            for child, leaves in sub.items():
                kind, _, index = child.rpartition("_")
                if kind == "Dense":
                    out.update(_dense(f"{name}.layers.{index}", leaves))
                elif kind == "Conv":
                    kernel = np.asarray(leaves["kernel"]).transpose(3, 2, 0, 1)
                    out[f"{name}.convs.{index}.weight"] = torch.as_tensor(kernel.copy())
                    out[f"{name}.convs.{index}.bias"] = torch.as_tensor(
                        np.asarray(leaves["bias"]).copy())
                elif kind == "LayerNorm" and set(leaves) == {"bias"}:
                    out[f"{name}.norm_biases.{index}"] = torch.as_tensor(
                        np.asarray(leaves["bias"]).copy()
                    )
                else:
                    raise KeyError(f"from_flax_params: unexpected torso child {child!r}")
        elif name == "action_head":
            for child, leaves in sub.items():
                if child == "Dense_0":
                    out.update(_dense("action_head.linear", leaves))
                elif child == "Dense_1":
                    out.update(_dense("action_head.log_std_linear", leaves))
                elif child == "log_std":
                    out["action_head.log_std"] = torch.as_tensor(np.asarray(leaves).copy())
                else:
                    raise KeyError(f"from_flax_params: unexpected action head child {child!r}")
        elif name == "Dense_0":  # the critic's value layer or the Q-network's head
            out.update(_dense(head, sub))
        else:
            raise KeyError(f"from_flax_params: unexpected flax module {name!r}")
    return out
