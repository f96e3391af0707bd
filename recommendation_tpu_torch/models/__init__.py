from recommendation_tpu_torch.models.registry import available, build, register

__all__ = ["available", "build", "register"]
