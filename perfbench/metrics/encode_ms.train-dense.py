"""``encode_ms.train`` in the dense training cell, where it moves
``train_rays_per_s.dense``: the same reader."""

from perfbench.harness import metric_reader

read = metric_reader("encode_ms.train")
