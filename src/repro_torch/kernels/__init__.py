"""The port's hand-written CUDA kernels, each beside its plain PyTorch
version. Importing the package registers every kernel's launch counter in
``dispatch.KERNELS``; nothing is built until a kernel first launches."""
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.dp_clip import dp_clip  # noqa: F401
from repro_torch.kernels.dp_fused import dp_fused  # noqa: F401
