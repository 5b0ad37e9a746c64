"""Scene-flow field: hash grid with the temporal Lagrange basis folded into
the table, then a bias-free MLP -> 6-dim (forward, backward) flow
(counterpart of ``nvsf_tpu/models/flow.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from nvsf_torch.models.hash_grid import HashEncoding, lagrange_fold_table
from nvsf_torch.models.mlp import MLP
from nvsf_torch.train.profiler import traced


class FlowField(nn.Module):

    def __init__(self, num_layers=3, hidden_dim=64, num_basis=4, n_levels=16,
                 n_features_per_level=8, base_resolution=32,
                 max_resolution=8192, log2_hashmap_size=18, generator=None):
        super().__init__()
        self.num_basis = num_basis
        self.enc = HashEncoding(dim=3, n_levels=n_levels,
                                n_features_per_level=n_features_per_level,
                                log2_hashmap_size=log2_hashmap_size,
                                base_resolution=base_resolution,
                                max_resolution=max_resolution)
        self.grid = nn.Parameter(self.enc.init(generator))
        # last layer N(0, 1e-3) (``flow_field.py:98-103``)
        self.mlp = MLP(self.enc.n_output_dims // num_basis, hidden_dim, 6,
                       num_layers, last_init_std=1e-3, generator=generator)

    @traced("encode.flow")
    def forward(self, xt: torch.Tensor, compute_dtype=torch.float32,
                precision: str = "f32") -> torch.Tensor:
        """xt: [N, 4] in [0,1] (xyz + one shared t) -> flow [N, 6]."""
        folded = lagrange_fold_table(self.grid, xt[0, 3], self.num_basis)
        h = self.enc.apply(folded, xt[:, :3], precision)
        return self.mlp(h, compute_dtype).to(torch.float32)
