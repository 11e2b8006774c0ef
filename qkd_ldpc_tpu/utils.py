"""Console utilities (the reference's L1 helpers, ``src/utils.{hpp,cpp}``).

The reference color-codes its console output with fmt: green = status,
purple/magenta = mode banners, red = errors, blue = traces (SURVEY.md §5
"Metrics / logging").  These helpers reproduce that scheme with plain ANSI,
honoring ``NO_COLOR`` and non-TTY streams.
"""

from __future__ import annotations

import os
import sys

_CODES = {
    "green": "\x1b[32m",
    "magenta": "\x1b[35m",
    "red": "\x1b[31m",
    "blue": "\x1b[34m",
}
_RESET = "\x1b[0m"


def _want_color(stream) -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    return hasattr(stream, "isatty") and stream.isatty()


def colorize(text: str, color: str, stream=None) -> str:
    """Wrap ``text`` in an ANSI color when the stream is a color TTY."""
    stream = stream if stream is not None else sys.stdout
    if not _want_color(stream):
        return text
    return f"{_CODES[color]}{text}{_RESET}"


def print_status(text: str) -> None:
    print(colorize(text, "green"))


def print_mode(text: str) -> None:
    print(colorize(text, "magenta"))


def print_error(text: str) -> None:
    print(colorize(text, "red", sys.stderr), file=sys.stderr)


def print_trace(text: str) -> None:
    print(colorize(text, "blue"))


def card_identity() -> str:
    """The GPU's name and power limit as ``nvidia-smi`` reports them, read
    by a child process that stays off JAX."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# Fixed compile-cache directory inside the checkout (listed in .gitignore):
# the cache key includes the path, so it must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> str | None:
    """Enable JAX's persistent compilation cache; returns the directory in
    use, or None when disabled.

    ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and nothing is
    set here.  Otherwise the cache lives at :data:`DEFAULT_CACHE_DIR`.
    ``QKD_LDPC_NO_COMPILE_CACHE=1`` turns the default off (the test suite
    does, so in-process CLI tests do not enable it for the whole run).
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    if os.environ.get("QKD_LDPC_NO_COMPILE_CACHE") == "1":
        return None
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_CACHE_DIR
