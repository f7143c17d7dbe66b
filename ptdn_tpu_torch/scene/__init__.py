from ptdn_tpu_torch.scene.scene import DeviceScene, Scene  # noqa: F401
