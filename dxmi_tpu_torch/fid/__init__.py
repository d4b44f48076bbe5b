"""FID for the port (``dxmi_tpu.fid``): the FID Inception-v3 (``inception``),
activation statistics and the Frechet distance (``stats``), the in-training
and entry-point orchestration (``runner``), image directories
(``image_dir``), the standalone CLI (``cli``) and the proxy weights and
statistics for a repository without the published files (``proxy``)."""
