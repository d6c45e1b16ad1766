# coding: utf-8
"""The shared schema of the ``WIRE_VERBS`` manifests.

Counterpart of ``mxnet_tpu/kvstore/wire_verbs.py``, kept as the port's
own copy.  A module that declares a wire surface (the parameter server's
``kvstore/server.py``) validates it with :func:`declare_verbs` at import
and gets back the plain dict it uses at run time, so callers of
``WIRE_VERBS[verb]["semantics"]`` read one schema.  The verbs dict stays
a literal at the call site, so tools can read it with ``ast``.

Per-verb fields
---------------
semantics : 'replayable' | 'idempotent'
    The client-visible delivery contract: replayable verbs burn exactly
    one effect per (client_id, seq) no matter how often the envelope is
    retried; idempotent verbs may re-execute harmlessly.
replay : 'cached' | 'bypass' | 'forward' | 'local'
    How the verb crosses the SEQ exactly-once layer: 'cached' resolves
    through the replay cache, 'bypass' dispatches around it (read-only
    or designed-no-op verbs), 'forward' (router only) ships the client
    envelope verbatim upstream, 'local' (router only) is answered from
    router-local state with no replay bookkeeping.
codec : str | None
    Wire codec pair name -- ``encode_<codec>/decode_<codec>`` exist in
    kvstore/wire_codec.py.
mutates : tuple of category names, default ()
    Which durable server/router state categories the handler is allowed
    to touch.  Vocabulary: %s.
stream : str, optional
    Name of the server->client frame verb a streaming response uses
    (e.g. GENERATE streams STREAM frames); the frame verb must be a
    declared idempotent row of the same manifest, and the emitting
    client must offset-dedupe re-delivered frames.
handler : str, optional
    Dotted name of the handling function, for documentation; defaults
    to the protocol-level ``handler=`` argument.
"""

__all__ = ["declare_verbs", "SEMANTICS", "REPLAY_CLASSES",
           "STATE_CATEGORIES", "ROLES"]

SEMANTICS = ("replayable", "idempotent")
REPLAY_CLASSES = ("cached", "bypass", "forward", "local")
ROLES = ("server", "router", "collector")
# durable/observable state categories a handler may declare it mutates
# (infrastructure churn — liveness stamps, telemetry, lock tables,
# routing pins, snapshot counters — is deliberately NOT declarable:
# the verifier treats it as benign)
STATE_CATEGORIES = ("kv", "optimizer", "membership", "epoch", "barrier",
                    "engine", "model", "lifecycle")

_ROW_KEYS = ("semantics", "replay", "codec", "mutates", "stream", "handler")

_STR = (str,)

if __doc__:                         # interpolate the vocabulary once
    __doc__ = __doc__ % (", ".join(STATE_CATEGORIES),)


def _fail(protocol, verb, why):
    raise ValueError("WIRE_VERBS[%r] of protocol %r: %s"
                     % (verb, protocol, why))


def declare_verbs(protocol, verbs, role="server", durable=False,
                  handler=None):
    """Validate one wire-surface manifest and return the verbs dict.

    ``role`` says which side of the wire this manifest describes (only
    routers may use the 'forward'/'local' replay classes).  ``durable``
    marks a server that persists its store AND replay cache in a crash
    snapshot — the model checker only explores crash-restart schedules
    against durable protocols.
    """
    if not isinstance(protocol, _STR) or not protocol:
        raise ValueError("declare_verbs: protocol must be a non-empty "
                         "string, got %r" % (protocol,))
    if role not in ROLES:
        raise ValueError("declare_verbs(%r): role %r not in %r"
                         % (protocol, role, ROLES))
    if not isinstance(durable, bool):
        raise ValueError("declare_verbs(%r): durable must be a bool"
                         % (protocol,))
    if handler is not None and not isinstance(handler, _STR):
        raise ValueError("declare_verbs(%r): handler must be a string"
                         % (protocol,))
    if not isinstance(verbs, dict) or not verbs:
        raise ValueError("declare_verbs(%r): verbs must be a non-empty "
                         "dict" % (protocol,))
    out = {}
    for verb, row in verbs.items():
        if not isinstance(verb, _STR) or not verb.isupper():
            _fail(protocol, verb, "verb names are UPPERCASE strings")
        if not isinstance(row, dict):
            _fail(protocol, verb, "row must be a dict")
        unknown = sorted(set(row) - set(_ROW_KEYS))
        if unknown:
            _fail(protocol, verb, "unknown fields %r (schema: %r)"
                  % (unknown, _ROW_KEYS))
        for required in ("semantics", "replay"):
            if required not in row:
                _fail(protocol, verb, "missing required field %r"
                      % (required,))
        if "codec" not in row:
            _fail(protocol, verb, "missing required field 'codec' "
                  "(use None for tuple-native payloads)")
        if row["semantics"] not in SEMANTICS:
            _fail(protocol, verb, "semantics %r not in %r"
                  % (row["semantics"], SEMANTICS))
        replay = row["replay"]
        if replay not in REPLAY_CLASSES:
            _fail(protocol, verb, "replay %r not in %r"
                  % (replay, REPLAY_CLASSES))
        if replay in ("forward", "local") and role != "router":
            _fail(protocol, verb, "replay class %r is router-only "
                  "(role is %r)" % (replay, role))
        if row["semantics"] == "replayable" and \
                replay not in ("cached", "forward"):
            _fail(protocol, verb, "a replayable verb must resolve "
                  "through a replay cache somewhere: replay must be "
                  "'cached' (this server) or 'forward' (the replica's "
                  "cache), not %r" % (replay,))
        codec = row["codec"]
        if codec is not None and not isinstance(codec, _STR):
            _fail(protocol, verb, "codec must be a string or None")
        mutates = row.get("mutates", ())
        if not isinstance(mutates, (tuple, list)):
            _fail(protocol, verb, "mutates must be a tuple of "
                  "category names")
        bad = sorted(set(mutates) - set(STATE_CATEGORIES))
        if bad:
            _fail(protocol, verb, "unknown state categories %r "
                  "(vocabulary: %r)" % (bad, STATE_CATEGORIES))
        row_handler = row.get("handler", handler)
        if row_handler is not None and not isinstance(row_handler, _STR):
            _fail(protocol, verb, "handler must be a string")
        stream = row.get("stream")
        if stream is not None and not isinstance(stream, _STR):
            _fail(protocol, verb, "stream must name a frame verb")
        out[verb] = dict(row, mutates=tuple(mutates))
        if row_handler is not None:
            out[verb]["handler"] = row_handler
    # second pass: stream frame verbs must be declared idempotent rows
    for verb, row in out.items():
        frame = row.get("stream")
        if frame is None:
            continue
        if frame not in out:
            _fail(protocol, verb, "stream frame verb %r is not a row "
                  "of this manifest" % (frame,))
        if out[frame]["semantics"] != "idempotent":
            _fail(protocol, verb, "stream frame verb %r must be "
                  "idempotent (frames re-deliver on failover)" % (frame,))
    return out
