"""CLI front-end of the port: python -m gatk_tpu_torch ToolName --args...

Tool names and flags mirror gatk_tpu's (and GATK4's); the registry holds the
tools ported so far and, last, the Spark-named aliases of tools/spark_compat.py
(TOOL_ALIASES maps each to its single-node tool).
"""
from __future__ import annotations

import argparse
import sys
import time

from .utils.errors import UserError

TOOL_REGISTRY = {}
TOOL_ALIASES = {}  # alias name -> target tool name (the Spark-named tools)

VERSION = "0.1.0-torch"


def register_tool(name, alias_of=None):
    def deco(fn):
        TOOL_REGISTRY[name] = fn
        if alias_of:
            TOOL_ALIASES[name] = alias_of
        return fn

    return deco


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--version":
        print(f"gatk_tpu_torch version: {VERSION}")
        return 0
    if not argv or argv[0] in ("-h", "--help", "--list"):
        print(f"gatk_tpu_torch: variant calling on NVIDIA GPUs. {len(TOOL_REGISTRY)} tools:")
        for name, fn in sorted(TOOL_REGISTRY.items()):
            doc = (fn.__doc__ or "").strip().splitlines()
            print(f"  {name:28s} {doc[0] if doc else ''}")
        return 0
    tool = argv[0]
    if tool not in TOOL_REGISTRY:
        print(f"ERROR: unknown tool '{tool}'. Use --list to see tools.", file=sys.stderr)
        return 2
    # --gatk-config-file is parsed before the tool, like Main.java:177-184
    rest = argv[1:]
    if "--gatk-config-file" in rest:
        from .utils.config import set_config_file

        i = rest.index("--gatk-config-file")
        set_config_file(rest[i + 1])
        rest = rest[:i] + rest[i + 2:]
    t0 = time.time()
    try:
        rc = TOOL_REGISTRY[tool](rest) or 0
    except UserError as e:
        print(f"A USER ERROR has occurred: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"A USER ERROR has occurred: file not found: {e.filename}", file=sys.stderr)
        return 2
    except KeyError as e:
        print(f"A USER ERROR has occurred: unknown identifier {e}", file=sys.stderr)
        return 2
    print(f"{tool} done. Elapsed time: {time.time() - t0:.2f} seconds.", file=sys.stderr)
    return rc


def standard_io_parser(description: str, reference_required=True):
    """Read input + reference + output + -L/-XL/-ip/-isr interval flags
    (cli_args.py)."""
    from . import cli_args

    p = argparse.ArgumentParser(description=description, add_help=True)
    cli_args.add_read_input_args(p, required=True)
    cli_args.add_reference_args(p, required=reference_required)
    cli_args.add_output_args(p)
    cli_args.add_interval_args(p)
    return p


def _register_builtin_tools():
    from .tools import hc_tool, mutect_tool  # noqa: F401
    from .tools import cnv_tools  # noqa: F401
    from .tools import somatic_cnv_tools  # noqa: F401
    from .tools import gvcf_tools, bqsr_tools, metrics_tools  # noqa: F401
    from .tools import ramped_hc_tool, variant_recalling_tool  # noqa: F401
    from .tools import vqsr_tools, groundtruth_tools, featuremapping_tools  # noqa: F401
    from .tools import varianteval_tool, funcotator_tool  # noqa: F401
    from .tools import variant_tools, basic_tools, analysis_tools  # noqa: F401
    from .tools import misc_tools, select_variants, variant_filtration  # noqa: F401
    from .tools import spark_compat  # noqa: F401  (last: it aliases registered tools)


_register_builtin_tools()
