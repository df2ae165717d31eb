"""File IO backends (the port's own copy of ``glare_tpu/sr/utils/file_client.py``;
reference: basicsr/utils/file_client.py).

The disk backend is complete. ``lmdb`` reads the portable ``.lmdb`` layout
(``data.pack`` + ``index.txt``) without any package and a standard
``data.mdb`` database through the ``lmdb`` package, imported when such a
database is opened; without it that raises an informative ImportError.
memcached raises at construction. ``cv2`` is imported inside
:func:`imfrombytes`.
"""

from __future__ import annotations

import os.path as osp


class BaseStorageBackend:
    def get(self, filepath):
        raise NotImplementedError


class HardDiskBackend(BaseStorageBackend):
    def get(self, filepath):
        with open(filepath, "rb") as f:
            return f.read()

    def get_text(self, filepath):
        with open(filepath, "r") as f:
            return f.read()


class _PackDb:
    """Reader of the portable ``.lmdb`` layout: ``data.pack`` (the values, one
    after another) and ``index.txt`` (``key\\toffset\\tlength`` lines)."""

    def __init__(self, db_path):
        import mmap

        self._index = {}
        with open(osp.join(db_path, "index.txt")) as f:
            for line in f:
                key, off, length = line.rstrip("\n").split("\t")
                self._index[key] = (int(off), int(length))
        self._f = open(osp.join(db_path, "data.pack"), "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)

    def get(self, key):
        if key not in self._index:
            return None
        off, length = self._index[key]
        return self._mm[off:off + length]


class LmdbBackend(BaseStorageBackend):
    """One database per ``client_key``, as in the reference's multi-db interface."""

    def __init__(self, db_paths, client_keys="default", readonly=True, lock=False,
                 readahead=False, **kwargs):
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError(f"{len(client_keys)} client keys for {len(db_paths)} databases")
        self._client = {}
        for k, p in zip(client_keys, db_paths):
            if osp.exists(osp.join(p, "data.pack")):
                self._client[k] = _PackDb(p)
                continue
            try:
                import lmdb
            except ImportError as e:
                raise ImportError(
                    f"{p} is a standard lmdb database; reading it requires the `lmdb` "
                    "package, which is not installed") from e
            self._client[k] = lmdb.open(p, readonly=readonly, lock=lock, readahead=readahead,
                                        **kwargs)

    def get(self, filepath, client_key="default"):
        client = self._client[client_key]
        if isinstance(client, _PackDb):
            return client.get(str(filepath))
        with client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class MemcachedBackend(BaseStorageBackend):
    def __init__(self, server_list_cfg, client_cfg, sys_path=None):
        raise ImportError("memcached backend requires mc/pymemcache packages")


class FileClient:
    """Dispatch by backend name."""

    _backends = {
        "disk": HardDiskBackend,
        "lmdb": LmdbBackend,
        "memcached": MemcachedBackend,
    }

    def __init__(self, backend="disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f"Backend {backend} not supported. Supported: {list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key="default"):
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath):
        return self.client.get_text(filepath)


def imfrombytes(content, flag="color", float32=False):
    """Decode image bytes (BGR for ``color``, as cv2 gives it)."""
    import cv2
    import numpy as np

    img_np = np.frombuffer(content, np.uint8)
    imread_flags = {
        "color": cv2.IMREAD_COLOR,
        "grayscale": cv2.IMREAD_GRAYSCALE,
        "unchanged": cv2.IMREAD_UNCHANGED,
    }
    img = cv2.imdecode(img_np, imread_flags[flag])
    if float32:
        img = img.astype("float32") / 255.0
    return img
