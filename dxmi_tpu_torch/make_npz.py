"""Pack a directory of generated PNGs into the evaluator's npz (``arr_0``
uint8 (N, H, W, 3)), as ``make_npz.py`` does:

    python -m dxmi_tpu_torch.make_npz --image_dir results/.../generated_best \
        --out samples.npz [--device cuda|cpu]

The PNGs are read by ``utils/png.py`` (no PIL) in sorted order and streamed
into the npz, so the images never sit on the host all at once. Nothing is
computed on the device; ``--device`` is checked as by the other commands.
"""
from __future__ import annotations

import argparse

from dxmi_tpu_torch.fid.image_dir import list_images
from dxmi_tpu_torch.runtime import select_device
from dxmi_tpu_torch.utils.npz_stream import NpzStreamWriter
from dxmi_tpu_torch.utils.png import read_png


def pack(image_dir: str, out: str) -> int:
    """Write every image under ``image_dir`` into ``out``; the count."""
    files = list_images(image_dir)
    if not files:
        raise SystemExit(f"no images under {image_dir}")
    first = read_png(files[0])
    with NpzStreamWriter(out, len(files), first.shape) as writer:
        writer.write(first[None])
        for f in files[1:]:
            writer.write(read_png(f)[None])
    print(f"packed {len(files)} images {first.shape} -> {out}")
    return len(files)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", "--image_dir", dest="image_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    select_device(args.device)
    pack(args.image_dir, args.out)


if __name__ == "__main__":
    main()
