"""Python client of the backend service (the port of
``whisperseg_tpu/services/client.py``, itself a port of the reference's
scripts/functions_for_calling_backend.py).

The same functions and answers; the requests go through the standard
library's ``urllib`` (multipart bodies made here), so that the client needs
no ``requests`` package. An HTTP error status returns its JSON body, as
``requests``' ``resp.json()`` does.
"""

from __future__ import annotations

import base64
import io
import json
import os
import urllib.error
import urllib.request
import uuid
import zipfile


def _zip_folder_bytes(folder_path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for root, _dirs, files in os.walk(folder_path):
            for fname in files:
                path = os.path.join(root, fname)
                zf.write(path, os.path.relpath(path, folder_path))
    return buf.getvalue()


def _post(url: str, body: bytes, content_type: str):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def _post_multipart(url: str, files: dict, data: dict):
    """POST ``files`` ({field: (filename, bytes)}) and ``data`` ({field:
    value}) as multipart/form-data."""
    boundary = uuid.uuid4().hex
    out = io.BytesIO()
    for name, value in data.items():
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f'name="{name}"\r\n\r\n{value}\r\n'.encode())
    for name, (filename, payload) in files.items():
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f'name="{name}"; filename="{filename}"\r\n'
                  f"Content-Type: application/octet-stream\r\n\r\n".encode())
        out.write(payload)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return _post(url, out.getvalue(),
                 f"multipart/form-data; boundary={boundary}")


def train(service_address: str, train_dataset_folder: str, model_name: str,
          initial_model_name: str = "whisperseg-base", num_epochs: int = 3,
          ignore_cluster: int = 0):
    """Zip a dataset folder in memory and submit a training request
    (reference functions_for_calling_backend.py:14-27)."""
    return _post_multipart(
        f"http://{service_address}/submit-training-request",
        files={"zip": ("dataset.zip", _zip_folder_bytes(train_dataset_folder))},
        data={"model_name": model_name,
              "initial_model_name": initial_model_name,
              "num_epochs": num_epochs,
              "ignore_cluster": ignore_cluster},
    )


def segment(service_address: str, audio_path: str, model_name: str,
            min_frequency=None, spec_time_step=None, channel_id: int = 0,
            num_trials: int = 1):
    """(reference functions_for_calling_backend.py:29-36)"""
    data = {"model_name": model_name, "channel_id": channel_id,
            "num_trials": num_trials}
    if min_frequency is not None:
        data["min_frequency"] = min_frequency
    if spec_time_step is not None:
        data["spec_time_step"] = spec_time_step
    with open(audio_path, "rb") as f:
        audio = f.read()
    return _post_multipart(
        f"http://{service_address}/segment",
        files={"audio_file": (os.path.basename(audio_path), audio)},
        data=data,
    )


def segment_base64(service_address: str, audio_path: str, sr: int, **kwargs):
    """Client of the single-model segment service (JSON base64 API)."""
    with open(audio_path, "rb") as f:
        payload = {"audio_file_base64_string":
                   base64.b64encode(f.read()).decode("ascii"), "sr": sr}
    payload.update(kwargs)
    return _post(f"http://{service_address}/segment",
                 json.dumps(payload).encode(), "application/json")
