"""How far the port's image readers are from PIL's, the JAX package's reader.

    python scripts/measure_image_reader_gap.py [--size 336x252] [--quality 95]

Writes, under a temporary directory, a smooth synthetic image with edges
(two ramps, a disc and a bar of saturated colors) as a PNG and as JPEGs of
4:2:0 and 4:4:4 chroma (OpenCV's encoder), then reads each with PIL
(``convert("RGB")``), with OpenCV and with the port's native libav decoder
at the image's own size (``data/video.py``'s rule when cv2 is missing), and
prints one JSON line per file and reader: the max and mean absolute
difference from PIL's pixels and the share of pixels that differ. Needs PIL,
cv2 and the libav headers (for the decoder's build).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def smooth_image_with_edges(h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8: horizontal and vertical ramps, a red disc and a
    green bar with hard edges."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([255 * x / (w - 1), 255 * y / (h - 1), 255 * (1 - x / (w - 1))], axis=-1)
    disc = (x - 0.35 * w) ** 2 + (y - 0.5 * h) ** 2 < (0.2 * min(h, w)) ** 2
    img[disc] = (230, 20, 20)
    img[int(0.7 * h):int(0.8 * h), int(0.55 * w):int(0.9 * w)] = (10, 200, 30)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="336x252", help="WxH")
    ap.add_argument("--quality", type=int, default=95)
    args = ap.parse_args()
    w, h = map(int, args.size.split("x"))

    import cv2
    from PIL import Image

    from open_o3_video_tpu_torch.data import video as TV
    from open_o3_video_tpu_torch.native import video_decoder

    img = smooth_image_with_edges(h, w)
    with tempfile.TemporaryDirectory() as d:
        files = {"png": os.path.join(d, "img.png")}
        cv2.imwrite(files["png"], img[:, :, ::-1])
        for name, sampling in (("jpeg 4:2:0", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                               ("jpeg 4:4:4", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)):
            files[name] = os.path.join(d, name.replace(" ", "_").replace(":", "") + ".jpg")
            cv2.imwrite(files[name], img[:, :, ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, args.quality,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
        for name, path in files.items():
            pil = np.asarray(Image.open(path).convert("RGB")).astype(np.int32)
            readers = {"cv2": TV.read_image(path), "native": TV._read_image_native(path)}
            for reader, got in readers.items():
                diff = np.abs(got.astype(np.int32) - pil)
                print(json.dumps({"file": name, "size": f"{w}x{h}", "quality": args.quality,
                                  "reader": reader, "max_abs": int(diff.max()),
                                  "mean_abs": round(float(diff.mean()), 4),
                                  "share_differing": round(float((diff > 0).mean()), 4)}))
    print(json.dumps({"decoder_missing": video_decoder.missing()}))


if __name__ == "__main__":
    main()
