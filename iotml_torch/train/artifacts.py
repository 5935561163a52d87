"""Model artifact store — the train→predict handoff
(``iotml.train.artifacts``'s ``ArtifactStore``).

The reference uploads the saved model to a GCS bucket after training and
the predict deployment downloads it fresh on start (cardata-v3.py:229-232,
:255-261).  ``ArtifactStore`` is that handoff: a local-directory backend,
and a GCS backend for ``gs://`` roots when ``google-cloud-storage`` is
installed (imported only then).  Objects are opaque blobs keyed by name;
a checkpoint directory moves as one zip blob, and ``put_text`` /
``get_text`` keep small pointer blobs (a model name).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

from ..store.segment import fsync_dir


class ArtifactStore:
    """upload/download blobs by name; scheme chosen from the root URI."""

    def __init__(self, root: str):
        self.root = root
        self._gcs = root.startswith("gs://")
        if self._gcs:
            from google.cloud import storage  # optional dependency

            bucket_name, _, self._prefix = root[5:].partition("/")
            self._bucket = storage.Client().get_bucket(bucket_name)
        else:
            os.makedirs(root, exist_ok=True)

    def _blob(self, name: str):
        return self._bucket.blob(os.path.join(self._prefix, name))

    def upload(self, local_path: str, name: str) -> str:
        """Publish a blob ATOMICALLY under ``name``.

        GCS object creation is atomic by the service's contract; a local
        upload stages to a pid-unique tmp, ``os.replace``s it into place
        and fsyncs the directory, so a reader never sees a torn blob and
        the rename survives a host crash."""
        if self._gcs:
            self._blob(name).upload_from_filename(local_path)
            return f"{self.root}/{name}"
        dst = os.path.join(self.root, name)
        dirname = os.path.dirname(dst) or "."
        os.makedirs(dirname, exist_ok=True)
        tmp = dst + f".tmp.{os.getpid()}"
        try:
            shutil.copy2(local_path, tmp)
            os.replace(tmp, dst)  # atomic within a filesystem
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        fsync_dir(dirname)
        return dst

    def download(self, name: str, local_path: str) -> str:
        if self._gcs:
            self._blob(name).download_to_filename(local_path)
            return local_path
        os.makedirs(os.path.dirname(os.path.abspath(local_path)),
                    exist_ok=True)
        shutil.copy2(os.path.join(self.root, name), local_path)
        return local_path

    def exists(self, name: str) -> bool:
        if self._gcs:
            return self._blob(name).exists()
        return os.path.exists(os.path.join(self.root, name))

    # ----------------------------------------------------- pointer blobs
    # The continuous train → serve handoff (``train.live`` /
    # ``serve.live``) flips a small "latest" pointer after each immutable
    # versioned model upload; a scorer polls it and hot-swaps.
    def put_text(self, name: str, text: str) -> None:
        """Write a text blob ATOMICALLY, as ``upload`` writes: a reader
        sees the old text or the new, never a torn one."""
        if self._gcs:
            self._blob(name).upload_from_string(text)  # atomic by contract
            return
        dst = os.path.join(self.root, name)
        dirname = os.path.dirname(dst) or "."
        os.makedirs(dirname, exist_ok=True)
        tmp = dst + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                fh.write(text)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, dst)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        fsync_dir(dirname)

    def get_text(self, name: str) -> Optional[str]:
        """A text blob, or None while it does not exist."""
        if self._gcs:
            blob = self._blob(name)
            return blob.download_as_bytes().decode() if blob.exists() \
                else None
        try:
            with open(os.path.join(self.root, name)) as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    def upload_tree(self, local_dir: str, name: str) -> str:
        """Ship a directory (a checkpoint step) as the zip blob
        ``<name>.zip``, staged in a unique directory so concurrent jobs
        on one host cannot interleave writes."""
        stage = tempfile.mkdtemp(prefix="iotml_torch_up_")
        try:
            archive = shutil.make_archive(os.path.join(stage, name), "zip",
                                          local_dir)
            return self.upload(archive, f"{name}.zip")
        finally:
            shutil.rmtree(stage, ignore_errors=True)

    def download_tree(self, name: str, local_dir: str) -> str:
        """Unpack the blob ``<name>.zip`` into ``local_dir``."""
        stage = tempfile.mkdtemp(prefix="iotml_torch_dl_")
        try:
            archive = self.download(f"{name}.zip",
                                    os.path.join(stage, f"{name}.zip"))
            shutil.unpack_archive(archive, local_dir, "zip")
        finally:
            shutil.rmtree(stage, ignore_errors=True)
        return local_dir
