"""Bias-free ReLU MLPs (counterpart of ``nvsf_tpu/models/mlp.py``).

Weights are stored [fan_in, fan_out]; each matmul runs in the compute dtype
(bf16 when the step trains in bf16), the inputs being cast at each layer.
The JAX package splits the first layer per input block to avoid lane-axis
concatenation on the TPU; here callers concatenate and run one matmul, which
is the same math.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class MLP(nn.ParameterList):
    """n_layers linear layers with ReLU between them (tcnn FullyFusedMLP
    with n_hidden_layers = n_layers - 1, no bias)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 n_layers: int = 3, last_init_std: Optional[float] = None,
                 generator=None):
        dims = [in_dim] + [hidden_dim] * (n_layers - 1) + [out_dim]
        weights = []
        for li in range(n_layers):
            fan_in, fan_out = dims[li], dims[li + 1]
            if li == n_layers - 1 and last_init_std is not None:
                w = last_init_std * torch.randn((fan_in, fan_out),
                                                generator=generator)
            else:   # He-uniform
                bound = (6.0 / fan_in) ** 0.5
                w = (torch.rand((fan_in, fan_out), generator=generator)
                     * 2 - 1) * bound
            weights.append(nn.Parameter(w))
        super().__init__(weights)
        self.in_dim = in_dim

    # ParameterList refuses to be called; an MLP is called like a Module
    __call__ = nn.Module.__call__

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        h = x.to(compute_dtype)
        last = len(self) - 1
        for li, w in enumerate(self):
            h = h @ w.to(compute_dtype)
            if li != last:
                h = torch.relu(h)
        return h
