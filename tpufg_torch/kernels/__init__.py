"""Hand-written CUDA kernels (with plain PyTorch versions) and the plain
torch search and warp ops of the port.

The package exports the kernel API of ``tpufg.kernels``, the same eight
names with the same contracts; the other entry points live in their
modules.
"""

from tpufg_torch.kernels.convert import frames_to_planar, planar_to_frames
from tpufg_torch.kernels.lanczos import lanczos_scale_fast
from tpufg_torch.kernels.motion import motion_search_tiled
from tpufg_torch.kernels.motion_xla import motion_search_xla
from tpufg_torch.kernels.resize import box_downsample2
from tpufg_torch.kernels.warp import warp_blend_block
from tpufg_torch.kernels.warp_matmul import warp_blend_matmul

__all__ = ["frames_to_planar", "planar_to_frames", "lanczos_scale_fast",
           "motion_search_tiled", "motion_search_xla", "box_downsample2",
           "warp_blend_block", "warp_blend_matmul"]
