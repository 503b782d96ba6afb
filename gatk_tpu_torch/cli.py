"""CLI front-end of the port: python -m gatk_tpu_torch ToolName --args...

Tool names and flags mirror gatk_tpu's (and GATK4's); the registry holds every
tool of gatk_tpu's and, last, the Spark-named aliases of tools/spark_compat.py
(TOOL_ALIASES maps each to its single-node tool).
"""
from __future__ import annotations

import argparse
import sys
import time

from .utils.errors import UserError

TOOL_REGISTRY = {}
TOOL_ALIASES = {}  # alias name -> target tool name (the Spark-named tools)

# cmdline/DeprecatedToolsRegistry.java: tools removed after their
# @DeprecatedFeature period, with the version they disappeared in and the
# recommended replacement
DEPRECATED_TOOLS = {
    "IndelRealigner": ("4.0.0.0", "Please use GATK3 to run this tool"),
    "RealignerTargetCreator": ("4.0.0.0", "Please use GATK3 to run this tool"),
    "CNNScoreVariants": ("4.6.1.0",
        "Please use the replacement tool NVScoreVariants instead, which "
        "produces virtually identical results"),
    "CNNVariantTrain": ("4.6.1.0",
        "Please use a version of GATK prior to 4.6.1.0 to run this tool, or "
        "wait for the forthcoming Pytorch-based training tool for "
        "NVScoreVariants to be released"),
    "CNNVariantWriteTensors": ("4.6.1.0",
        "Please use a version of GATK prior to 4.6.1.0 to run this tool, or "
        "wait for the forthcoming Pytorch-based training tool for "
        "NVScoreVariants to be released"),
}

# Main.java:513-514 getUnknownCommandMessage tuning
_HELP_SIMILARITY_FLOOR = 7
_MINIMUM_SUBSTRING_LENGTH = 5


def _levenshtein(a: str, b: str, swap_penalty: int = 0) -> int:
    """Damerau-Levenshtein distance (StringUtils.levenshteinDistance with the
    git-style 0-cost swap used by Main.getSuggestedAlternateCommand)."""
    la, lb = len(a), len(b)
    prev2 = None
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if prev2 is not None and i > 1 and j > 1 and \
                    a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]:
                cur[j] = min(cur[j], prev2[j - 2] + swap_penalty)
        prev2, prev = prev, cur
    return prev[lb]


def unknown_command_message(command: str) -> str | None:
    """Main.java:502-560: a deprecation notice if the tool was removed, else a
    git-style 'did you mean' using case-insensitive Damerau-Levenshtein with a
    substring shortcut."""
    if command in DEPRECATED_TOOLS:
        ver, msg = DEPRECATED_TOOLS[command]
        return (f"{command} is no longer included in GATK as of version "
                f"{ver}. {msg}")
    lower = command.lower()
    best = None
    for name in TOOL_REGISTRY:
        nl = name.lower()
        if len(lower) >= _MINIMUM_SUBSTRING_LENGTH and lower in nl:
            d = 0
        else:
            d = _levenshtein(lower, nl)
        if d <= _HELP_SIMILARITY_FLOOR and (best is None or d < best[0]):
            best = (d, [name])
        elif best is not None and d == best[0]:
            best[1].append(name)
    if best is None:
        return None
    return "Did you mean this?\n" + "\n".join(f"        {n}" for n in sorted(best[1]))


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
        hint = unknown_command_message(tool)
        if hint:
            print(hint, file=sys.stderr)
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
    # in the order of gatk_tpu/cli.py
    from .tools import hc_tool  # noqa: F401
    from .tools import basic_tools  # noqa: F401
    from .tools import bqsr_tools  # noqa: F401
    from .tools import mutect_tool  # noqa: F401
    from .tools import gvcf_tools  # noqa: F401
    from .tools import cnv_tools  # noqa: F401
    from .tools import somatic_cnv_tools  # noqa: F401
    from .tools import vqsr_tools  # noqa: F401
    from .tools import rnaseq_tools  # noqa: F401
    from .tools import metrics_tools  # noqa: F401
    from .tools import varianteval_tool  # noqa: F401
    from .tools import dragstr_tools  # noqa: F401
    from .tools import funcotator_tool  # noqa: F401
    from .tools import util_tools  # noqa: F401
    from .tools import sv_tools  # noqa: F401
    from .tools import variant_tools  # noqa: F401
    from .tools import analysis_tools  # noqa: F401
    from .tools import vets_tools  # noqa: F401
    from .tools import pathseq_tools  # noqa: F401
    from .tools import sam_tools  # noqa: F401
    from .tools import fasta_tools  # noqa: F401
    from .tools import plotting_tools  # noqa: F401
    from .tools import featuremapping_tools  # noqa: F401
    from .tools import realignment_tools  # noqa: F401
    from .tools import ramped_hc_tool  # noqa: F401
    from .tools import validation_tools  # noqa: F401
    from .tools import groundtruth_tools  # noqa: F401
    from .tools import sv_discovery_tool  # noqa: F401
    from .tools import variant_recalling_tool  # noqa: F401
    from .tools import saturation_mutagenesis_tool  # noqa: F401
    from .tools import example_tools  # noqa: F401
    from .tools import misc_tools  # noqa: F401
    from .tools import picard_tools  # noqa: F401
    from .tools import picard_tools2  # noqa: F401
    from .tools import cpx_reinterpreter  # noqa: F401
    from .tools import select_variants  # noqa: F401
    from .tools import variant_filtration  # noqa: F401
    from .tools import hadoop_compat  # noqa: F401
    from .tools import barclay_tools  # noqa: F401
    from .tools import spark_compat  # noqa: F401  (last: it aliases registered tools)


_register_builtin_tools()
