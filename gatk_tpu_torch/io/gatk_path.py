# Copied verbatim from gatk_tpu/io/gatk_path.py; only import lines may differ.
"""URI-capable path handling (engine/GATKPath.java equivalent).

Reference behavior: GATKPath wraps every tool input so local paths, file://
URIs, and cloud URIs (gs://, hdfs://, http(s)://) flow through one type; the
NIO providers then open channels for whichever scheme. This deployment is
zero-egress, so cloud schemes resolve through a configurable local mirror
(GATK_TPU_URI_MIRROR="gs://bucket/prefix=>/local/dir;hdfs://x=>/y") instead of
a network client; an unmapped cloud URI fails with an actionable UserError
rather than a stack trace.
"""
from __future__ import annotations

import os
import urllib.parse

from ..utils.errors import UserError

CLOUD_SCHEMES = ("gs", "s3", "hdfs", "http", "https")


class GATKPath(str):
    """A path or URI; str-compatible so it threads through existing io code."""

    @property
    def scheme(self) -> str:
        head = self.split("://", 1)
        return head[0] if len(head) == 2 and "/" not in head[0] else ""

    @property
    def is_cloud(self) -> bool:
        return self.scheme in CLOUD_SCHEMES

    def local(self) -> str:
        return resolve(self)


def _mirror_map():
    spec = os.environ.get("GATK_TPU_URI_MIRROR", "")
    out = []
    for part in spec.split(";"):
        if "=>" in part:
            src, dst = part.split("=>", 1)
            out.append((src.strip(), dst.strip()))
    return out


def resolve(path: str) -> str:
    """Local filesystem path for a path-or-URI (GATKPath.toPath equivalent).

    file:// URIs unwrap; cloud URIs go through the GATK_TPU_URI_MIRROR prefix
    map; plain paths pass through untouched."""
    s = str(path)
    scheme = s.split("://", 1)[0] if "://" in s else ""
    if scheme == "file":
        parsed = urllib.parse.urlparse(s)
        return urllib.parse.unquote(parsed.path)
    if scheme in CLOUD_SCHEMES:
        for src, dst in _mirror_map():
            if s.startswith(src):
                return dst + s[len(src):]
        raise UserError(
            f"cannot open {s}: cloud URIs need network access and this "
            f"deployment is offline. Map a local mirror with "
            f'GATK_TPU_URI_MIRROR="{scheme}://bucket/prefix=>/local/dir" '
            f"or copy the file locally.")
    return s
