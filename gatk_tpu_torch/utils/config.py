# Copied verbatim from gatk_tpu/utils/config.py; only import lines may differ.
"""Layered configuration system.

Reference: utils/config/GATKConfig.java:30-36 + ConfigFactory.java (the owner
library): properties resolve in priority order system properties > environment
variables > --gatk-config-file properties file > packaged defaults, with typed
accessors. Here: GATK_TPU_* environment variables > config file (java
.properties syntax) > defaults.
"""
from __future__ import annotations

import os

_DEFAULTS = {
    # mirrors GATKConfig defaults that have referents in this framework
    "gatk_stacktrace_on_user_exception": "false",
    "samjdk.use_async_io_read_samtools": "false",
    "samjdk.compression_level": "2",
    "pairhmm.device_bucket_max": "992",
    "pairhmm.f64_fallback": "true",
    "cloudPrefetchBuffer": "40",
    "codec_packages": "gatk_tpu.io",
    "read_filter_packages": "gatk_tpu.engine.filters",
    "annotation_packages": "gatk_tpu.gvcf.annotations",
}

ENV_PREFIX = "GATK_TPU_"


def _parse_properties(path: str) -> dict:
    """java.util.Properties-style key=value / key: value lines."""
    out = {}
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith(("#", "!")):
                continue
            for sep in ("=", ":"):
                if sep in line:
                    k, _, v = line.partition(sep)
                    out[k.strip()] = v.strip()
                    break
    return out


class GATKConfig:
    """Layered typed accessors (GATKConfig.java @Sources order)."""

    def __init__(self, config_file: str | None = None, defaults: dict | None = None):
        self.defaults = dict(_DEFAULTS)
        if defaults:
            self.defaults.update(defaults)
        self.file_values = _parse_properties(config_file) if config_file else {}

    def get(self, key: str, default=None):
        env_key = ENV_PREFIX + key.replace(".", "_").upper()
        if env_key in os.environ:
            return os.environ[env_key]
        if key in self.file_values:
            return self.file_values[key]
        return self.defaults.get(key, default)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        return str(v).strip().lower() in ("true", "1", "yes", "on")

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        return default if v is None else int(str(v).strip())

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        return default if v is None else float(str(v).strip())

    def get_list(self, key: str, default=()) -> list:
        v = self.get(key)
        if v is None:
            return list(default)
        return [x.strip() for x in str(v).split(",") if x.strip()]


_global_config: GATKConfig | None = None


def get_config() -> GATKConfig:
    global _global_config
    if _global_config is None:
        _global_config = GATKConfig(os.environ.get("GATK_TPU_CONFIG_FILE"))
    return _global_config


def set_config_file(path: str | None):
    """Install the --gatk-config-file layer (Main.java:177-184 pre-tool parse)."""
    global _global_config
    _global_config = GATKConfig(path)
