"""What the reference works out once per configuration and traffic mix
(training targets and the pairs each camera needs), kept in
``splatbench/_cache/<config>.<traffic>/`` under a key of the configuration,
the mix and the reference's source, so that a change to any of them makes
it anew."""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from splatbench.harness.spec import PKG

DIR = os.path.join(PKG, "_cache")


def key(config: dict, traffic: dict) -> str:
    h = hashlib.sha256(json.dumps([config, traffic], sort_keys=True).encode())
    ref = os.path.join(PKG, "reference")
    for f in sorted(os.listdir(ref)):
        if f.endswith(".py"):
            with open(os.path.join(ref, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def folder(config: dict, traffic: dict) -> str:
    d = os.path.join(DIR, f"{config['name']}.{traffic['name']}",
                     key(config, traffic))
    os.makedirs(d, exist_ok=True)
    return d


def _replace(path: str, write):
    part = path + ".part"
    write(part)
    os.replace(part, path)


def load_arrays(d: str, name: str):
    path = os.path.join(d, name + ".npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_arrays(d: str, name: str, arrays: dict):
    def write(part):
        with open(part, "wb") as f:
            np.savez(f, **arrays)
    _replace(os.path.join(d, name + ".npz"), write)


def load_json(d: str, name: str) -> dict:
    path = os.path.join(d, name + ".json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def save_json(d: str, name: str, obj: dict):
    def write(part):
        with open(part, "w") as f:
            json.dump(obj, f)
    _replace(os.path.join(d, name + ".json"), write)
