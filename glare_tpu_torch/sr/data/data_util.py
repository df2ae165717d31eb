"""Paired-path collection across storage layouts (the port's own copy of
``glare_tpu/sr/data/data_util.py``; reference: basicsr/data/data_util.py):
folder pairs, ``.lmdb`` databases (keys from ``meta_info.txt``) and
meta-info-file listings with a filename template."""

from __future__ import annotations

import os
import os.path as osp


def paired_paths_from_folder(folders, keys, filename_tmpl="{}"):
    """Paired paths from two folders, matched by the GT file's basename."""
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_names = sorted(os.listdir(input_folder))
    gt_names = sorted(os.listdir(gt_folder))
    if len(input_names) != len(gt_names):
        raise ValueError(f"{input_key} and {gt_key} datasets have different number of images: "
                         f"{len(input_names)}, {len(gt_names)}.")
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(gt_name)
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        paths.append({f"{input_key}_path": osp.join(input_folder, input_name),
                      f"{gt_key}_path": osp.join(gt_folder, gt_name)})
    return paths


def paired_paths_from_lmdb(folders, keys):
    """Paired keys of two ``.lmdb`` folders: one shared key per pair."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError(f"two folders and two keys, got {folders}, {keys}")
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    if not (input_folder.endswith(".lmdb") and gt_folder.endswith(".lmdb")):
        raise ValueError(f"{input_key} folder and {gt_key} folder should both be in lmdb "
                         f"format, but received {input_folder}; {gt_folder}")
    with open(osp.join(input_folder, "meta_info.txt")) as fin:
        input_keys = [line.split(".")[0] for line in fin]
    with open(osp.join(gt_folder, "meta_info.txt")) as fin:
        gt_keys = [line.split(".")[0] for line in fin]
    if set(input_keys) != set(gt_keys):
        raise ValueError(f"Keys in {input_key}_folder and {gt_key}_folder are different.")
    return [{f"{input_key}_path": k, f"{gt_key}_path": k} for k in sorted(input_keys)]


def paired_paths_from_meta_info_file(folders, keys, meta_info_file, filename_tmpl="{}"):
    """Paired paths from a meta-info listing (the GT name first on each line)."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError(f"two folders and two keys, got {folders}, {keys}")
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file) as fin:
        gt_names = [line.strip().split(" ")[0] for line in fin]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        paths.append({f"{input_key}_path": osp.join(input_folder, input_name),
                      f"{gt_key}_path": osp.join(gt_folder, gt_name)})
    return paths


def paths_from_folder(folder):
    return [osp.join(folder, name) for name in sorted(os.listdir(folder))]


def paths_from_lmdb(folder):
    if not folder.endswith(".lmdb"):
        raise ValueError(f"Folder {folder} should be in lmdb format.")
    with open(osp.join(folder, "meta_info.txt")) as fin:
        return [line.split(".")[0] for line in fin]
