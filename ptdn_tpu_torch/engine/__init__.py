from ptdn_tpu_torch.engine.renderer import Renderer  # noqa: F401
