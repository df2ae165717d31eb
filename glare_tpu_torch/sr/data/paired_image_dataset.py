"""Stage-1 datasets (counterpart of ``glare_tpu/sr/data/paired_image_dataset.py``;
reference: basicsr/data/paired_image_dataset.py with the RIDCP pipeline).

``PairedImageDataset``: LQ / GT pairs from folders, ``.lmdb`` databases
(``io_backend.type: lmdb``) or a ``meta_info_file`` listing; training samples are
a paired random crop of ``gt_size`` with flip / rotation. ``SingleImageDataset``:
GT-only images for HQ codebook pretraining (lq == gt). Samples are NHWC
float32 RGB in [0, 1] with their paths. ``cv2`` is imported where images are
decoded.
"""

from __future__ import annotations

import os

import numpy as np

from ...data.lol_dataset import augment, paired_random_crop
from ..registry import DATASET_REGISTRY
from ..utils.file_client import FileClient, imfrombytes
from .data_util import paired_paths_from_folder, paired_paths_from_lmdb, paired_paths_from_meta_info_file


@DATASET_REGISTRY.register()
class PairedImageDataset:
    def __init__(self, opt):
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        self.lq_folder = opt["dataroot_lq"]
        self.filename_tmpl = opt.get("filename_tmpl", "{}")
        self.io_backend_opt = dict(opt.get("io_backend") or {"type": "disk"})
        self.file_client = None  # built at the first read
        if self.io_backend_opt["type"] == "lmdb":
            self.io_backend_opt["db_paths"] = [self.lq_folder, self.gt_folder]
            self.io_backend_opt["client_keys"] = ["lq", "gt"]
            self.paths = paired_paths_from_lmdb([self.lq_folder, self.gt_folder], ["lq", "gt"])
        elif opt.get("meta_info_file"):
            self.paths = paired_paths_from_meta_info_file(
                [self.lq_folder, self.gt_folder], ["lq", "gt"], opt["meta_info_file"], self.filename_tmpl)
        else:
            self.paths = paired_paths_from_folder([self.lq_folder, self.gt_folder], ["lq", "gt"],
                                                  self.filename_tmpl)

    def __len__(self):
        return len(self.paths)

    def _read(self, path, client_key):
        if self.file_client is None:
            backend = dict(self.io_backend_opt)
            self.file_client = FileClient(backend.pop("type"), **backend)
        img = imfrombytes(self.file_client.get(path, client_key))  # BGR uint8
        return img[:, :, ::-1].astype(np.float32) / 255.0

    def __getitem__(self, index):
        p = self.paths[index]
        lq = self._read(p["lq_path"], "lq")
        gt = self._read(p["gt_path"], "gt")
        if self.opt.get("phase") == "train":
            gt, lq, _ = paired_random_crop(gt, lq, None, self.opt["gt_size"], self.opt.get("scale", 1))
            gt, lq = augment([gt, lq], self.opt.get("use_hflip", True), self.opt.get("use_rot", True))
        return {"lq": np.ascontiguousarray(lq), "gt": np.ascontiguousarray(gt),
                "lq_path": p["lq_path"], "gt_path": p["gt_path"]}


@DATASET_REGISTRY.register()
class SingleImageDataset:
    """GT-only dataset for HQ codebook pretraining (lq == gt)."""

    def __init__(self, opt):
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        self.paths = [os.path.join(self.gt_folder, n) for n in sorted(os.listdir(self.gt_folder))]

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        import cv2

        img = cv2.imread(self.paths[index])
        if img is None:
            raise IOError(f"cannot read {self.paths[index]}")
        gt = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        if self.opt.get("phase") == "train":
            gt, _, _ = paired_random_crop(gt, gt, None, self.opt["gt_size"], 1)
            (gt,) = augment([gt], self.opt.get("use_hflip", True), self.opt.get("use_rot", True))
        gt = np.ascontiguousarray(gt)
        return {"lq": gt, "gt": gt, "lq_path": self.paths[index], "gt_path": self.paths[index]}
