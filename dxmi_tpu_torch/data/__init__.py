"""Data for the port's entry points (``dxmi_tpu.data``)."""
