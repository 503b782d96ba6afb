# Copied verbatim from gatk_tpu/tools/barclay_tools.py; only import lines may differ.
"""Barclay-surface utilities: WDL generation and shell tab completion.

Reference behavior: Barclay's WDLGen doclet (gatk scripts generate per-tool
WDL wrappers) and BashTabCompletionDoclet; plus Main.java:489-560's
deprecation / closest-command machinery (implemented in cli.py).

Both generators introspect a tool's argparse parser by invoking the tool with
a capturing parse_args hook — no per-tool metadata needed."""
from __future__ import annotations

import argparse
import contextlib
import io
import os

from ..cli import TOOL_ALIASES, TOOL_REGISTRY, register_tool
from ..utils.errors import UserError


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


@contextlib.contextmanager
def _capturing_parsers():
    """Patch ArgumentParser.parse_args to raise the parser itself."""
    orig = argparse.ArgumentParser.parse_args

    def fake(self, *a, **k):
        raise _Captured(self)

    argparse.ArgumentParser.parse_args = fake
    try:
        yield
    finally:
        argparse.ArgumentParser.parse_args = orig


def capture_tool_parser(name):
    """The argparse parser a tool would use, or None (non-argparse tools)."""
    fn = TOOL_REGISTRY[name]
    with _capturing_parsers(), contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            fn([])
        except _Captured as c:
            return c.parser
        except Exception:
            return None
    return None


def _wdl_type(action):
    if isinstance(action, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
        return "Boolean"
    t = getattr(action, "type", None)
    if t is int:
        return "Int"
    if t is float:
        return "Float"
    base = "File" if _is_file_arg(action) else "String"
    if getattr(action, "nargs", None) == "+" or isinstance(
            action, argparse._AppendAction):
        return f"Array[{base}]"
    return base


def _is_file_arg(action):
    d = (action.dest or "").lower()
    return d in ("input", "reference", "variant", "output", "intervals") or \
        any(k in d for k in ("file", "path", "bam", "vcf", "fasta"))


def _wdl_name(action):
    return action.dest


def generate_wdl(name) -> str:
    """A runnable WDL task wrapping `python -m gatk_tpu <name>` (Barclay
    WDLGen equivalent: one task, typed inputs, localized File args)."""
    parser = capture_tool_parser(name)
    if parser is None:
        raise UserError(f"{name} does not expose an argparse surface")
    inputs, cmd_parts = [], []
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction) or not a.option_strings:
            continue
        wname = _wdl_name(a)
        wtype = _wdl_type(a)
        required = a.required
        opt = sorted(a.option_strings, key=len)[-1]  # longest = descriptive
        if required:
            inputs.append(f"    {wtype} {wname}")
        else:
            inputs.append(f"    {wtype}? {wname}")
        if wtype == "Boolean":
            cmd_parts.append(f"~{{true='{opt}' false='' {wname}}}")
        elif wtype.startswith("Array"):
            cmd_parts.append(f"~{{sep=' ' prefix('{opt} ', select_first([{wname}, []]))}}")
        else:
            cmd_parts.append(f"~{{'{opt} ' + {wname}}}")
    nl = "\n"
    return f"""version 1.0

task {name} {{
  input {{
{nl.join(inputs)}
  }}
  command <<<
    python -m gatk_tpu_torch {name} \\
      {" ".join(cmd_parts)}
  >>>
  output {{
    File? out = output
  }}
  runtime {{
    docker: "gatk-tpu:latest"
  }}
}}
"""


@register_tool("GenerateToolWdl")
def generate_tool_wdl(argv):
    """Generate a WDL task wrapper for a tool (Barclay WDLGen equivalent)."""
    p = argparse.ArgumentParser(description="GenerateToolWdl")
    p.add_argument("--tool", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    if args.tool not in TOOL_REGISTRY:
        raise UserError(f"unknown tool {args.tool}")
    with open(args.output, "w") as fh:
        fh.write(generate_wdl(args.tool))
    print(f"wrote WDL for {args.tool} to {args.output}")
    return 0


@register_tool("GenerateShellCompletion")
def generate_shell_completion(argv):
    """Emit a bash tab-completion script covering every registered tool name
    and, per tool, its flags (Barclay BashTabCompletionDoclet equivalent)."""
    p = argparse.ArgumentParser(description="GenerateShellCompletion")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--with-flags", action="store_true",
                   help="also capture per-tool flag lists (slower)")
    args = p.parse_args(argv)
    names = sorted(n for n in TOOL_REGISTRY if n not in TOOL_ALIASES)
    flag_cases = ""
    if args.with_flags:
        cases = []
        for n in names:
            parser = capture_tool_parser(n)
            if parser is None:
                continue
            flags = sorted({o for a in parser._actions for o in a.option_strings})
            cases.append(f'    {n}) opts="{" ".join(flags)}" ;;')
        flag_cases = "\n".join(cases)
    script = f"""# bash completion for gatk_tpu (generated by GenerateShellCompletion)
_gatk_tpu_complete() {{
  local cur prev tools opts
  COMPREPLY=()
  cur="${{COMP_WORDS[COMP_CWORD]}}"
  tools="{" ".join(names)}"
  if [[ $COMP_CWORD -eq 1 ]]; then
    COMPREPLY=( $(compgen -W "$tools --list --help" -- "$cur") )
    return 0
  fi
  opts=""
  case "${{COMP_WORDS[1]}}" in
{flag_cases}
    *) opts="" ;;
  esac
  COMPREPLY=( $(compgen -W "$opts" -- "$cur") )
}}
complete -o default -F _gatk_tpu_complete gatk_tpu
complete -o default -F _gatk_tpu_complete gatk-tpu
"""
    with open(args.output, "w") as fh:
        fh.write(script)
    print(f"wrote completion for {len(names)} tools to {args.output}")
    return 0
