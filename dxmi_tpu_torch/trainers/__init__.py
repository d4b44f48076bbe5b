"""DxMI trainers (``dxmi_tpu.trainers``)."""
