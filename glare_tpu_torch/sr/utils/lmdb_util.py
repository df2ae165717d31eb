"""LMDB dataset builder (counterpart of ``glare_tpu/sr/utils/lmdb_util.py``;
reference: basicsr/utils/lmdb_util.py). Host code.

Writes the reference's ``.lmdb`` dataset layout:

    example.lmdb
    ├── data.mdb + lock.mdb    (a standard lmdb database, through the `lmdb`
    │                           package when it is installed)
    ├── data.pack + index.txt  (the portable layout, written when `lmdb` is
    │                           absent: the values one after another, and
    │                           `key\\toffset\\tlength` lines)
    └── meta_info.txt          (one line per image: `key.png (h,w,c) <cl>`)

Keys are image names without extension; values are cv2 png bytes at
``compress_level``. The port's ``FileClient('lmdb')`` and
``sr/data/data_util.paired_paths_from_lmdb`` read either layout. ``cv2`` and
``lmdb`` are imported where they are used.
"""

from __future__ import annotations

import os
import os.path as osp


def _lmdb_module():
    """The `lmdb` package, or None when it is not installed (the portable layout)."""
    try:
        import lmdb
    except ImportError:
        return None
    return lmdb


def read_img_worker(path, key, compress_level):
    """Read and png-encode one image -> (key, bytes, (h, w, c))."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read {path}")
    if img.ndim == 2:
        h, w = img.shape
        c = 1
    else:
        h, w, c = img.shape
    _, img_byte = cv2.imencode(
        ".png", img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level]
    )
    return key, img_byte.tobytes(), (h, w, c)


class LmdbMaker:
    """Incremental writer of one ``.lmdb`` folder (either layout)."""

    def __init__(self, lmdb_path, map_size=1024 ** 4, batch=5000, compress_level=1):
        if not lmdb_path.endswith(".lmdb"):
            raise ValueError("lmdb_path must end with '.lmdb'")
        if osp.exists(lmdb_path):
            raise FileExistsError(f"Folder {lmdb_path} already exists.")
        os.makedirs(lmdb_path)
        self.lmdb_path = lmdb_path
        self.batch = batch
        self.compress_level = compress_level
        self.counter = 0
        self.txt_file = open(osp.join(lmdb_path, "meta_info.txt"), "w")
        lmdb = _lmdb_module()
        if lmdb is not None:
            self.env = lmdb.open(lmdb_path, map_size=map_size)
            self.txn = self.env.begin(write=True)
            self.pack = None
        else:
            self.env = None
            self.pack = open(osp.join(lmdb_path, "data.pack"), "wb")
            self.index = open(osp.join(lmdb_path, "index.txt"), "w")
            self.offset = 0

    def put(self, img_byte, key, img_shape):
        self.counter += 1
        if self.env is not None:
            self.txn.put(key.encode("ascii"), img_byte)
            if self.counter % self.batch == 0:
                self.txn.commit()
                self.txn = self.env.begin(write=True)
        else:
            self.pack.write(img_byte)
            self.index.write(f"{key}\t{self.offset}\t{len(img_byte)}\n")
            self.offset += len(img_byte)
        h, w, c = img_shape
        self.txt_file.write(f"{key}.png ({h},{w},{c}) {self.compress_level}\n")

    def close(self):
        if self.env is not None:
            self.txn.commit()
            self.env.close()
        else:
            self.pack.close()
            self.index.close()
        self.txt_file.close()


def make_lmdb_from_imgs(
    data_path,
    lmdb_path,
    img_path_list,
    keys,
    batch=5000,
    compress_level=1,
    multiprocessing_read=False,
    n_thread=40,
    map_size=None,
):
    """Make an ``.lmdb`` dataset from images. ``img_path_list`` entries are
    relative to ``data_path``; ``keys`` are the database keys (image names
    without extension); ``multiprocessing_read`` reads and encodes every image
    first with a pool of ``n_thread`` processes."""
    if len(img_path_list) != len(keys):
        raise ValueError(f"img_path_list and keys should have the same length, "
                         f"but got {len(img_path_list)} and {len(keys)}")
    print(f"Create lmdb for {data_path}, save to {lmdb_path}...")
    print(f"Total images: {len(img_path_list)}")
    if not lmdb_path.endswith(".lmdb"):
        raise ValueError("lmdb_path must end with '.lmdb'.")
    if osp.exists(lmdb_path):
        raise FileExistsError(f"Folder {lmdb_path} already exists. Exit.")

    dataset = {}
    shapes = {}
    if multiprocessing_read:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(processes=n_thread) as pool:
            results = [
                pool.apply_async(
                    read_img_worker,
                    (osp.join(data_path, path), key, compress_level),
                )
                for path, key in zip(img_path_list, keys)
            ]
            for r in results:
                key, img_byte, shape = r.get()
                dataset[key] = img_byte
                shapes[key] = shape

    if map_size is None and _lmdb_module() is not None:
        # estimate from the first image
        _, first_byte, _ = read_img_worker(
            osp.join(data_path, img_path_list[0]), keys[0], compress_level
        )
        map_size = len(first_byte) * len(img_path_list) * 10

    maker = LmdbMaker(
        lmdb_path, map_size=map_size or 1024 ** 4, batch=batch,
        compress_level=compress_level,
    )
    for idx, (path, key) in enumerate(zip(img_path_list, keys)):
        if multiprocessing_read:
            img_byte, shape = dataset[key], shapes[key]
        else:
            _, img_byte, shape = read_img_worker(
                osp.join(data_path, path), key, compress_level
            )
        maker.put(img_byte, key, shape)
    maker.close()
    print("Finish writing lmdb.")
