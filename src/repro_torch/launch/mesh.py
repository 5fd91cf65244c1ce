"""The card's mesh and constants: the one-card twin of
``repro/launch/mesh.py``.

JAX's dry run lowers every cell on a production mesh of 256 or 512 TPU
chips (``make_production_mesh``, ``make_mesh_from_config``). The port runs
on one H100, so those functions have no counterpart here: its mesh is one
data slot (``mesh_config``), and a cell either fits the one card or waits
for four (``ROADMAP.md`` queue 1 item 14). The constants below take the
place of JAX's TPU v5e ones (``mesh.py:31-34``): the roofline terms of the
dry run's records, and the memory its plan fills.
"""
from __future__ import annotations

from repro_torch.configs.base import MeshConfig

# one H100 SXM (NVIDIA data sheet): the dense bf16 rate of the tensor
# cores, the HBM3 bandwidth and capacity
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12          # bytes/s
HBM_BYTES = 80e9          # bytes: the card's 80 GB


def mesh_config() -> MeshConfig:
    """The one-card mesh: one data slot."""
    return MeshConfig((1,), ("data",))
