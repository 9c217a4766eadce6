"""Dataset download and unpack; counterpart of
``gcnn_keras_tpu/data/download.py`` (``DownloadDataset``, kgcnn's
``data/download.py``), copied so that the port imports nothing of the JAX
package.

An archive is fetched to ``<data_main_dir>/<dataset_name>/`` only when it
is missing there (or ``reload=True``), and each unpack step is skipped when
its output exists unless ``reload`` forces it again. The default root,
``DATASET_ROOT``, is the JAX package's, so an archive either package has
fetched serves the other. ``file://`` URLs work, so a local archive can be
served offline; an archive placed at its path in the root by hand is found
without any fetch. A failed fetch is logged and the build goes on: the
dataset's ``read_in_memory`` then raises ``FileNotFoundError``.
"""
from __future__ import annotations

import gzip
import logging
import os
import shutil
import tarfile
import zipfile
from typing import Optional

logger = logging.getLogger(__name__)

DATASET_ROOT = os.path.expanduser("~/.gcnn_keras_tpu/datasets")


class DownloadDataset:
    def __init__(self, dataset_name: str, download_url: Optional[str] = None,
                 download_file_name: Optional[str] = None,
                 unpack_tar: bool = False, unpack_zip: bool = False,
                 unpack_directory_name: Optional[str] = None,
                 extract_gz: bool = False,
                 extract_file_name: Optional[str] = None,
                 reload: bool = False, data_main_dir: Optional[str] = None,
                 **kwargs):
        self.dataset_name = dataset_name
        self.download_url = download_url
        self.download_file_name = download_file_name
        self.data_main_dir = data_main_dir or DATASET_ROOT
        self.data_directory_name = dataset_name
        self.data_directory = os.path.join(self.data_main_dir, dataset_name)
        self.unpack_directory_name = unpack_directory_name
        self.extract_file_name = extract_file_name
        os.makedirs(self.data_directory, exist_ok=True)
        if download_url and download_file_name:
            path = os.path.join(self.data_directory, download_file_name)
            if reload or not os.path.exists(path):
                self._download(download_url, path)
            if unpack_tar and os.path.exists(path):
                self._untar(path, unpack_directory_name, reload)
            if unpack_zip and os.path.exists(path):
                self._unzip(path, unpack_directory_name, reload)
            if extract_gz and os.path.exists(path):
                self._gunzip(path, extract_file_name, reload)

    def _download(self, url: str, path: str):
        import urllib.request
        logger.info("downloading %s -> %s", url, path)
        try:
            urllib.request.urlretrieve(url, path)
        except Exception as e:  # offline: the reader raises later
            logger.warning("download failed (%s); place the file at %s by hand", e, path)

    def _out_dir(self, out_name: Optional[str]) -> str:
        return os.path.join(self.data_directory, out_name) if out_name else self.data_directory

    def _untar(self, path: str, out_name: Optional[str], reload: bool):
        out = self._out_dir(out_name)
        if out_name and os.path.isdir(out) and not reload:
            logger.info("unpacked directory %s exists; skipping untar", out)
            return
        with tarfile.open(path) as tar:
            # the "data" filter refuses absolute paths and links that leave
            # the target; the argument exists from Python 3.10.12/3.11.4/3.12
            try:
                tar.extractall(out, filter="data")
            except TypeError:
                tar.extractall(out)

    def _unzip(self, path: str, out_name: Optional[str], reload: bool):
        out = self._out_dir(out_name)
        if out_name and os.path.isdir(out) and not reload:
            logger.info("unpacked directory %s exists; skipping unzip", out)
            return
        with zipfile.ZipFile(path) as z:
            z.extractall(out)

    def _gunzip(self, path: str, out_name: Optional[str], reload: bool):
        out = os.path.join(self.data_directory, out_name) if out_name \
            else (path[:-3] if path.endswith(".gz") else path + ".out")
        if os.path.exists(out) and not reload:
            logger.info("extracted file %s exists; skipping gunzip", out)
            return
        with gzip.open(path, "rb") as f_in, open(out, "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
