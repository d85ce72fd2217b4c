"""Single-garment SKIT dataset (``vts_tpu/data/singleskit.py``), test and
training phases.

One garment = sketch S + visual I + object mask M + touch records; an
edited sketch (a dataroot named ``*edit*`` with no I folder) has S and M
only, and its samples no I and no touch keys.  A sample
is a crop (``crop_size``; the center crop at test time, a random crop that
keeps the protected center with ``--preprocess crop``) made a multiple of
256, with every touch ROI propagated analytically; with ``zoom`` in
``--preprocess`` the garment is first scaled (LANCZOS) by the sample's zoom
levels, drawn once per dataset in [1/random_scale_max, 1) in training (1 at
test time) from a generator seeded by ``seed + 7919``.  Each surviving record
gives up to ``sample_bbox_per_patch`` 32² squares centered in its
contact-center mask — the middle candidates at test time, random ones in
training — resampled to ``batch_size_G2`` patches with a validity mask.  In
training the resampling is weighted by the sketch patch's Laplacian
variance (clamped to [resampling_w_min, resampling_w_max]), and the
``val_*`` set (``batch_size_G2_val`` patches from the validation records)
rides along.  Samples are fixed-shape numpy NHWC float32, drawn from a
generator seeded per (seed, index), so a sample is the same every epoch.

``synthetic://`` dataroots are built in memory (:mod:`.synthetic`); an
on-disk dataroot is decoded with PIL, imported only then, as is PIL for a
resize (a zoom, a crop larger than the image).  The reference's on-disk
sample cache is not ported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from . import coords as C
from .npz import TouchRecord, list_images, list_touch_npz, load_touch_npz
from .transforms import crop_img, make_power_2_img, to_array, variance_of_laplacian, zoom_img

AUG_KEYS = (
    "H", "W", "crop_pos_x", "crop_pos_y", "crop_size_h", "crop_size_w",
    "patch_crop_size", "resize_ratio", "resize_ratio_h", "resize_ratio_w",
    "scale_factor_h", "scale_factor_w",
)


def pack_aug_params(aug: Dict[str, float]) -> np.ndarray:
    return np.array([aug[k] for k in AUG_KEYS], np.float32)


def _resolve_padded_size(dataroot: str, default: int = 1800) -> Optional[int]:
    """Global padding is encoded in the dataroot name ('..._padded_1800_x1')."""
    if "padded" in dataroot:
        try:
            return int(dataroot.split("padded_")[1].split("/")[0].split("_")[0])
        except (IndexError, ValueError):
            return default
    return None


def _read_image(path: str, gray: bool) -> np.ndarray:
    from PIL import Image, ImageOps
    img = Image.open(path)
    return np.asarray(ImageOps.grayscale(img) if gray else img.convert("RGB"))


class SingleSkitDataset:
    """Map-style dataset of fixed-shape sample dicts (numpy, NHWC)."""

    def __init__(self, opt):
        self.is_train = bool(opt.isTrain)
        self.opt = opt
        self.data_len = int(opt.data_len)
        self.patch_crop_size = 32
        self.mult = int(opt.T_resolution_multiplier)
        self.seed = int(opt.seed)
        self.M_img = None
        if opt.dataroot.startswith("synthetic://"):
            from .synthetic import materialize_synthetic
            g = materialize_synthetic(opt.dataroot, opt)
            self.name = f"{g.name}_sketch"
            self.padded_size = g.padded_size
            self.S_img, self.I_img = g.sketch, g.image
            if opt.use_bg_mask:
                self.M_img = g.mask
            self.records = g.records["trainT" if self.is_train else "testT"]
            self.val_records = g.records["valT"] if self.is_train else []
        else:
            root = opt.dataroot
            self.padded_size = _resolve_padded_size(root)
            sub = lambda d: os.path.join(root, d)
            s_paths = list_images(sub(opt.subdir_S))
            if len(s_paths) != 1:
                raise ValueError(f"SingleSkit expects exactly one sketch, got {s_paths}")
            self.name = os.path.splitext(os.path.basename(s_paths[0]))[0]
            self.S_img = _read_image(s_paths[0], gray=opt.sketch_nc == 1)
            if opt.use_bg_mask:
                self.M_img = _read_image(list_images(sub(opt.subdir_M))[0], gray=True)
            if os.path.exists(sub(opt.subdir_I)):
                self.I_img = _read_image(list_images(sub(opt.subdir_I))[0], gray=False)
                self.records = [load_touch_npz(p) for p in list_touch_npz(sub(opt.subdir_T))]
            elif "edit" in root:                        # an edited sketch: S and M only
                self.I_img, self.records = None, []
            else:
                raise ValueError("I and T data required for non-edited sketches")
            val_dir = getattr(opt, "subdir_valT", "") if self.is_train else ""
            self.val_records = [load_touch_npz(p) for p in list_touch_npz(sub(val_dir))] \
                if val_dir else []

        zoom_max = 1.0 / float(opt.random_scale_max) if self.is_train else 1.0
        self.zoom_levels = np.random.default_rng(self.seed + 7919).uniform(
            zoom_max, 1.0, size=(self.data_len, 2))

    def __len__(self) -> int:
        return self.data_len

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sample = self.build_sample(index)
        sample["sample_idx"] = np.int64(index)
        return sample

    def build_sample(self, index: int) -> Dict[str, np.ndarray]:
        opt = self.opt
        rng = np.random.default_rng((self.seed << 20) ^ index)
        sf_h = sf_w = 1.0
        S1, I1, M1 = self.S_img, self.I_img, self.M_img
        if "zoom" in opt.preprocess:
            sf_h, sf_w = (float(v) for v in self.zoom_levels[index])
            S1 = zoom_img(S1, sf_h, sf_w)
            I1, M1 = (zoom_img(im, sf_h, sf_w) if im is not None else None for im in (I1, M1))
        center_crop = "crop" not in opt.preprocess
        S2, rr, cx, cy = crop_img(S1, opt.crop_size, opt.crop_size,
                                  center_w=opt.center_w, center_h=opt.center_h,
                                  center_crop=center_crop, rng=rng)
        I2, M2 = (crop_img(im, opt.crop_size, opt.crop_size, rr, cx, cy)[0]
                  if im is not None else None for im in (I1, M1))
        S3, rw, rh = make_power_2_img(S2, 256)
        I3, M3 = (make_power_2_img(im, 256)[0] if im is not None else None
                  for im in (I2, M2))
        aug = {
            "H": float(self.S_img.shape[0]), "W": float(self.S_img.shape[1]),
            "scale_factor_h": sf_h, "scale_factor_w": sf_w,
            "crop_size_h": float(opt.crop_size), "crop_size_w": float(opt.crop_size),
            "resize_ratio": float(rr), "crop_pos_x": float(cx), "crop_pos_y": float(cy),
            "resize_ratio_w": float(rw), "resize_ratio_h": float(rh),
            "patch_crop_size": float(self.patch_crop_size),
        }
        sample: Dict[str, np.ndarray] = {
            "S": to_array(S3, normalize=True),
            "augmentation_params": pack_aug_params(aug),
        }
        if I3 is not None:
            sample["I"] = to_array(I3, normalize=True)
        if M3 is not None:
            sample["M"] = (to_array(M3, normalize=False) > 0.5).astype(np.float32)
        if self.records:
            s3_gray = np.asarray(S3, np.float32)           # 0..255, the weight scale
            if s3_gray.ndim == 3:
                s3_gray = s3_gray[..., 0]
            sample.update(self._extract_patches(self.records, aug, M3, rng,
                                                k_out=int(opt.batch_size_G2) or 64,
                                                weighted=self.is_train, s3_gray=s3_gray))
            if self.val_records:
                val = self._extract_patches(self.val_records, aug, M3, rng,
                                            k_out=int(opt.batch_size_G2_val) or 128,
                                            weighted=False, s3_gray=s3_gray)
                sample.update({f"val_{k}": val[k]
                               for k in ("T_images", "T_coords", "I_masks", "T_valid")})
        return sample

    def _extract_patches(self, records: List[TouchRecord], aug: Dict, M3,
                         rng: np.random.Generator, k_out: int, weighted: bool,
                         s3_gray: np.ndarray) -> Dict[str, np.ndarray]:
        """Propagate ROIs, take each record's contact squares (the middle ones
        at test time, random ones in training), resample to k_out with a
        validity mask (reference singleskit_dataset.py:434-1128)."""
        from scipy.ndimage import maximum_filter
        opt = self.opt
        mult = self.mult
        pc = self.patch_crop_size
        pct = pc * mult
        m3_arr = np.asarray(M3, np.float32)
        if m3_arr.max() > 1:
            m3_arr = m3_arr / 255.0
        imgs, coords_list, masks, weights, full_rois = [], [], [], [], []
        for rec in records:
            roi = C.ROI(rec.roi_x, rec.roi_y, rec.roi_h, rec.roi_w)
            if self.padded_size is not None:
                roi = C.pad_roi(roi, org_w=opt.center_w, org_h=opt.center_h,
                                padded_size=self.padded_size)
            roi = C.zoom_roi(roi, aug["scale_factor_h"], aug["scale_factor_w"])
            valid, roi = C.crop_roi(roi, aug["crop_size_h"], aug["crop_size_w"],
                                    aug["resize_ratio"], aug["crop_pos_x"], aug["crop_pos_y"])
            if not valid:
                continue
            roi = C.make_power_2_roi(roi, aug["resize_ratio_w"], aug["resize_ratio_h"])
            roi_i = C.ROI(*(int(round(v)) for v in roi))
            if m3_arr[roi_i.y:roi_i.y + roi_i.h, roi_i.x:roi_i.x + roi_i.w].sum() == 0:
                continue
            full_rois.append([roi_i.x, roi_i.y, roi_i.h, roi_i.w])
            th, tw = rec.gx.shape
            m_aligned = m3_arr[roi_i.y:roi_i.y + th // mult, roi_i.x:roi_i.x + tw // mult]
            if mult != 1:
                m_aligned = np.kron(m_aligned, np.ones((mult, mult), np.float32))
            m_aligned = m_aligned[:th, :tw]
            combined = (rec.touch_mask[:m_aligned.shape[0], :m_aligned.shape[1]]
                        * m_aligned >= 1.0)
            window_hit = maximum_filter(combined.astype(np.uint8), size=pct,
                                        mode="constant", cval=0)
            cys, cxs = np.nonzero(rec.touch_center_mask[:combined.shape[0],
                                                        :combined.shape[1]] > 0)
            y0s = cys - pct // 2
            x0s = cxs - pct // 2
            ok = ((y0s >= 0) & (x0s >= 0) & (y0s + pct <= th) & (x0s + pct <= tw)
                  & (window_hit[cys, cxs] > 0))
            cand_x = x0s[ok]
            cand_y = y0s[ok]
            if cand_x.size == 0:
                continue
            n_pick = min(cand_x.size, int(opt.sample_bbox_per_patch))
            if self.is_train:
                picks = rng.choice(cand_x.size, size=n_pick, replace=False).tolist()
            else:
                start = cand_x.size // 2
                picks = range(start, min(start + n_pick, cand_x.size))
            for pidx in picks:
                x0, y0 = int(cand_x[pidx]), int(cand_y[pidx])
                merged = rec.touch_mask[y0:y0 + pct, x0:x0 + pct] \
                    * m_aligned[y0:y0 + pct, x0:x0 + pct]
                gxy = np.stack([rec.gx[y0:y0 + pct, x0:x0 + pct],
                                rec.gy[y0:y0 + pct, x0:x0 + pct]], axis=-1)
                imgs.append(gxy.astype(np.float32))
                coords_list.append(C.pack_patch_coords(
                    C.ROI(roi_i.x, roi_i.y, roi_i.h, roi_i.w), pc, 1.0,
                    x0 // mult, y0 // mult))
                masks.append(merged.astype(np.float32)[..., None])
                if weighted:
                    sy, sx = roi_i.y + y0 // mult, roi_i.x + x0 // mult
                    s_patch = s3_gray[sy:sy + pc, sx:sx + pc]
                    weights.append(variance_of_laplacian(s_patch) if s_patch.size else 1.0)

        total = len(imgs)
        out = {
            "T_images": np.zeros((k_out, pct, pct, 2), np.float32),
            "T_coords": np.zeros((k_out, C.N_COORD_FIELDS), np.float32),
            "I_masks": np.zeros((k_out, pct, pct, 1), np.float32),
            "T_valid": np.zeros((k_out,), np.float32),
            "full_T_coords": np.asarray(full_rois, np.float32).reshape(-1, 4)
            if full_rois else np.zeros((0, 4), np.float32),
        }
        if total == 0:
            return out
        if weighted and weights:
            w = np.clip(np.asarray(weights, np.float64), opt.resampling_w_min,
                        opt.resampling_w_max)
            sel = rng.choice(total, size=k_out, replace=True, p=w / w.sum())
        elif total >= k_out:
            sel = rng.choice(total, size=k_out, replace=False)
        else:
            sel = np.concatenate([np.arange(total),
                                  rng.choice(total, size=k_out - total, replace=True)])
        out["T_images"] = np.stack([imgs[i] for i in sel]).astype(np.float32)
        out["T_coords"] = np.stack([coords_list[i] for i in sel]).astype(np.float32)
        out["I_masks"] = np.stack([masks[i] for i in sel]).astype(np.float32)
        out["T_valid"] = np.ones((k_out,), np.float32)
        return out
