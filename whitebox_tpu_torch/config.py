"""Settings persistence — replaces src/config.{h,cpp}.

Counterpart of ``whitebox_tpu/config.py``. The reference stores
device/engine settings as JSON at a platform path (config.cpp:17,28-126
load / :158-196 save; keys: audio type/device ids/buffer size/sample
rate/exclusive mode, plus browser user_dirs). The offline framework keeps
the same shape minus physical devices: the render defaults and the
engine, which the CLI (``cli.py``) takes as the defaults of its flags.
The JAX package's ``enable_compilation_cache`` has no counterpart: the
port compiles its kernels once per source into ``build/``
(``buildlib.py``); nor do its ``output_channels`` and ``user_dirs``,
which nothing reads (the CLI renders stereo and has no sample browser):
a file that holds them still loads, the keys ignored.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from pathlib import Path


def default_settings_path() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME") or os.path.join(os.path.expanduser("~"), ".config")
    return Path(base) / "whitebox_tpu_torch" / "settings.json"


@dataclass
class Settings:
    # audio.* (config.cpp keys, device ids dropped — no realtime devices)
    sample_rate: int = 48000
    buffer_size: int = 512  # emulated engine block (event semantics)
    # render.*: bounce's engine (render/bounce.py): the CUDA mix kernel
    # with the gather fallback, the kernel only, or the gather mix
    engine: str = "auto"  # auto | pallas | xla
    interpolation: str = "linear"  # linear | catmull | sinc
    chunk_frames: int = 1 << 17
    strict_order: bool = True  # False: the CLI's --fast-sum by default

    def save(self, path=None) -> Path:
        p = Path(path) if path is not None else default_settings_path()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(asdict(self), indent=2))
        return p

    @staticmethod
    def load(path=None) -> "Settings":
        p = Path(path) if path is not None else default_settings_path()
        if not p.is_file():
            return Settings()
        try:
            doc = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return Settings()
        s = Settings()
        for k, v in doc.items():
            if hasattr(s, k):
                setattr(s, k, v)
        return s
