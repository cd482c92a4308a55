from repro_torch.utils import flops  # noqa: F401
