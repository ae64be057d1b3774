"""Single-file checkpoints: the payload check and torn-proof file I/O.

The port's own copy of the single-file half of
``hetu_tpu/graph/checkpoint.py`` (``CheckpointError``, ``validate_state``,
``atomic_write_bytes``, ``atomic_pickle``, ``read_checkpoint``), which
``Executor.save`` / ``load`` go through.  One key differs from the JAX
package's contract: the executor's random state is the bytes of its
``torch.Generator`` (``generator_state``) where JAX keeps its PRNG key
(``base_key``), because a JAX key cannot seed a torch generator.  Sharded
checkpoints (``save_sharded``, ``restore_sharded_state``) arrive with
slice F (ROADMAP.md).
"""

from __future__ import annotations

import os
import pickle


class CheckpointError(RuntimeError):
    """A checkpoint file or payload is torn, corrupt, or structurally
    invalid: raised instead of the ``KeyError`` or unpickling error that
    such a file would otherwise give, so that a caller can tell a bad file
    from a bug."""


# the single-file checkpoint contract (Executor.state_dict); "format" and
# "opt_meta" are optional, as in the JAX package
REQUIRED_STATE_KEYS = frozenset(
    {"params", "opt_state", "global_step", "generator_state"})
SUPPORTED_FORMAT_VERSIONS = (1,)


def validate_state(state, source="checkpoint"):
    """Check a checkpoint payload against the state_dict contract.

    Raises :class:`CheckpointError` naming what is wrong (not a dict,
    missing required keys, a format version from a newer writer)."""
    if not isinstance(state, dict):
        raise CheckpointError(
            f"{source}: payload is {type(state).__name__}, expected the "
            "dict produced by Executor.state_dict()")
    missing = sorted(REQUIRED_STATE_KEYS - set(state))
    if missing:
        raise CheckpointError(
            f"{source}: missing required keys {missing} — not an "
            "Executor checkpoint (or a torn/stale file)")
    for key in ("params", "opt_state"):
        if not isinstance(state[key], dict):
            raise CheckpointError(
                f"{source}: {key!r} is {type(state[key]).__name__}, "
                "expected a dict")
    fmt = state.get("format")
    if fmt is not None:
        if not isinstance(fmt, dict):
            raise CheckpointError(
                f"{source}: 'format' is {type(fmt).__name__}, expected a "
                "dict tag")
        version = fmt.get("version")
        if version is not None and version not in SUPPORTED_FORMAT_VERSIONS:
            raise CheckpointError(
                f"{source}: format version {version} is newer than this "
                f"build supports ({SUPPORTED_FORMAT_VERSIONS})")
    return state


def atomic_write_bytes(blob, path):
    """Write ``blob`` to ``path`` through a temporary file in the same
    directory and ``os.replace``: a kill mid-write leaves the previous file
    intact, never a half-written one under the final name."""
    path = str(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return path


def atomic_pickle(state, path):
    """Pickle ``state`` to ``path`` torn-proof (temporary file +
    ``os.replace``)."""
    return atomic_write_bytes(
        pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL), path)


def read_checkpoint(path):
    """Read, unpickle and validate a single-file checkpoint.

    A garbage, truncated or non-checkpoint file raises
    :class:`CheckpointError` naming the path; a missing file stays a
    ``FileNotFoundError``."""
    with open(path, "rb") as f:
        blob = f.read()
    try:
        state = pickle.loads(blob)
    except Exception as e:  # unpickling raises many types on garbage
        raise CheckpointError(
            f"{path}: not a readable checkpoint "
            f"({type(e).__name__}: {e}) — torn write or corrupt file?"
        ) from e
    return validate_state(state, source=str(path))
