"""Output directory management + args.json run manifest.

Port of ``vae_training_tpu/runio/outdir.py``: ``-ow`` recursively clears
the directory, an existing name without ``-ow`` raises, and an in-place
resume keeps every artifact and reports flags that changed. In a
multi-process run only the primary process makes and writes the directory
(``utils/process.is_primary``); the others get its path.
"""

from __future__ import annotations

import json
import os
import shutil
import sys


def get_output_dir(name: str, data_dir: str = "data") -> str:
    return os.path.join(data_dir, name)


def make_output_dir(name: str, overwrite: bool, cfg, data_dir: str = "data",
                    reuse_existing: bool = False) -> str:
    dirname = get_output_dir(name, data_dir)
    from ..utils.process import is_primary

    if not is_primary():
        return dirname
    os.makedirs(data_dir, exist_ok=True)
    if os.path.exists(dirname) and reuse_existing:
        pass  # in-place resume: keep every artifact, refresh the manifest
    elif os.path.exists(dirname):
        if overwrite:
            for entry in os.listdir(dirname):
                path = os.path.join(dirname, entry)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
        else:
            raise ValueError(f"{dirname} already exists! Use a different name")
    else:
        os.makedirs(dirname)
    args_name = os.path.join(dirname, "args.json")
    payload = cfg.to_json_dict() if hasattr(cfg, "to_json_dict") else dict(vars(cfg))
    if reuse_existing and os.path.exists(args_name):
        try:
            with open(args_name) as f:
                prev = json.load(f)
            invocation_keys = {"resume", "overwrite"}
            changed = sorted(k for k in payload
                             if k not in invocation_keys
                             and k in prev and prev[k] != payload[k])
            if changed:
                print(f"[outdir] resume overrides recorded flags: "
                      f"{', '.join(changed)}", file=sys.stderr, flush=True)
        except (OSError, ValueError):
            pass
    tmp = args_name + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, args_name)
    return dirname
