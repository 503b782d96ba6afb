# Copied verbatim from gatk_tpu/utils/errors.py; only import lines may differ.
"""Exception taxonomy: user errors vs tool bugs vs usage errors.

Reference: Main.java:204-230 (user exceptions print "A USER ERROR has
occurred" with no stack trace and exit 2; unexpected exceptions are bugs —
stack trace, exit 1; command-line parse errors print usage, exit 1) and
exceptions/UserException.java / GATKException.java.
"""
from __future__ import annotations


class GATKException(Exception):
    """Unexpected internal error — a bug in the toolkit (GATKException.java).
    Printed with a stack trace; exit code 1."""


class UserError(Exception):
    """Error caused by bad user input (UserException.java) — printed without a
    stack trace; exit code 2."""


class CommandLineError(UserError):
    """Bad command line (Barclay CommandLineException) — printed with the
    tool's usage; exit code 2."""


class CouldNotReadInput(UserError):
    def __init__(self, path, reason=""):
        super().__init__(f"Couldn't read file {path}. {reason}".rstrip())


class CouldNotCreateOutput(UserError):
    def __init__(self, path, reason=""):
        super().__init__(f"Couldn't write file {path}. {reason}".rstrip())


class MalformedFile(UserError):
    def __init__(self, path, reason=""):
        super().__init__(f"File {path} is malformed: {reason}".rstrip())


class BadInput(UserError):
    pass


class MissingReference(UserError):
    def __init__(self, msg="A reference (-R) is required for this tool"):
        super().__init__(msg)


EXIT_OK = 0
EXIT_BUG = 1
EXIT_USER = 2


def exit_code_for(exc: BaseException) -> int:
    """Main.java's exception -> process exit code mapping."""
    if isinstance(exc, UserError):
        return EXIT_USER
    if isinstance(exc, (FileNotFoundError, PermissionError, IsADirectoryError)):
        return EXIT_USER
    return EXIT_BUG
