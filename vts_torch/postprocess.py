"""Haptic-rendering postprocess (``vts_tpu/postprocess.py``; reference
Step2_Postprocessing_for_Rendering.py:18-406), the paper's step 2.

Turns a generated tactile gradient field, the ``*_fake_gxgy_raw.npz`` that
the test driver writes, into a friction map for the TanvasTouch display:
gz = gx² + gy² (float64, normalised to its max) → a threshold at the
``quantile`` of the nonzero values → a nonlinear map (``equalize``: CLAHE,
``dilation``: a 5×5 grey dilation, ``log10``, ``exp2`` or ``linear``) →
clip to [0, 1] after dividing by the max → a bicubic resize (PIL) to the
1280×800 display.  Host work on numpy arrays, as in the reference: CLAHE
runs through OpenCV when ``cv2`` is importable, else the reference's global
histogram equalization.

Run:  python -m vts_torch.postprocess --input results/.../x_fake_gxgy_raw.npz --mode equalize
"""

from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

MODES = ("equalize", "dilation", "log10", "exp2", "linear")


def equalize_adaptive(img: np.ndarray, clip_limit: float = 2.0,
                      grid: int = 8) -> np.ndarray:
    """CLAHE of ``img`` in [0, 1] on its uint8 quantization, back in [0, 1]
    as float32 (reference myutils.py:86-144's ``equalize_this``); without
    OpenCV a global histogram equalization."""
    u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    try:
        import cv2
        out = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=(grid, grid)).apply(u8)
    except ImportError:
        hist, _ = np.histogram(u8, bins=256, range=(0, 255))
        cdf = hist.cumsum()
        cdf = (cdf - cdf.min()) / max(cdf.max() - cdf.min(), 1)
        out = (cdf[u8] * 255).astype(np.uint8)
    return out.astype(np.float32) / 255.0


def dilate(img: np.ndarray, k: int = 5) -> np.ndarray:
    from scipy.ndimage import grey_dilation
    return grey_dilation(img, size=(k, k))


def postprocess_gz(gx: np.ndarray, gy: np.ndarray, mode: str = "equalize",
                   quantile: float = 0.5, out_size=(800, 1280)) -> np.ndarray:
    """The friction map in [0, 1] at ``out_size`` (h, w), float32."""
    gz = gx.astype(np.float64) ** 2 + gy.astype(np.float64) ** 2
    gz = gz / max(gz.max(), 1e-12)
    thresh = np.quantile(gz[gz > 0], quantile) if (gz > 0).any() else 0.0
    gz = np.where(gz >= thresh, gz, 0.0)
    if mode == "equalize":
        gz = equalize_adaptive(gz)
    elif mode == "dilation":
        gz = dilate(gz)
    elif mode == "log10":
        gz = np.log10(1.0 + 9.0 * gz)
    elif mode == "exp2":
        gz = np.exp2(gz) - 1.0
    elif mode != "linear":
        raise NotImplementedError(f"postprocess mode {mode!r}")
    gz = np.clip(gz / max(gz.max(), 1e-12), 0, 1)
    img = Image.fromarray((gz * 255).astype(np.uint8))
    img = img.resize((out_size[1], out_size[0]), Image.BICUBIC)
    return np.asarray(img).astype(np.float32) / 255.0


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="friction map for the TanvasTouch display")
    ap.add_argument("--input", required=True, help="fake_gxgy_raw.npz path")
    ap.add_argument("--output", default="", help="output PNG (default: alongside input)")
    ap.add_argument("--mode", default="equalize", choices=MODES)
    ap.add_argument("--quantile", type=float, default=0.5)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=800)
    args = ap.parse_args(argv)
    with np.load(args.input) as data:
        gz = postprocess_gz(data["gx"], data["gy"], args.mode, args.quantile,
                            (args.height, args.width))
    out = args.output or args.input.replace(".npz", f"_friction_{args.mode}.png")
    Image.fromarray((gz * 255).astype(np.uint8)).save(out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
