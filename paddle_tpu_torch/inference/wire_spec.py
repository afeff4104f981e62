"""wire_spec: the port's own copy of the serving wire protocol's tables
and codec (paddle_tpu/inference/wire_spec.py is the source of truth; the
port keeps a copy because it imports nothing of the JAX package, and
tests/test_torch_serving.py holds the two tables equal).

Framing (little-endian throughout)::

    request:  u32 body_len | u8 cmd | payload
    response: u32 body_len | u8 status | payload

A cmd-1 infer payload is ``u8 n_inputs`` followed by one array block per
input (``u8 dtype_code | u8 ndim | i64 dims[ndim] | data``, row-major),
optionally followed by 9-byte marker-tagged fields (``u8 marker |
8-byte payload``) in any order, each marker at most once; parsing stops
at the first unknown marker.

Only the tables and codec the one-shot server uses are copied; the
kv-snapshot codec, the error taxonomy and the implementation
declarations come with the slices that serve them.
"""
import struct
from collections import namedtuple

import numpy as np

#: The version of the reference spec these tables copy.
SPEC_VERSION = 2

# --------------------------------------------------------------- dtypes

WireDtype = namedtuple("WireDtype", "code name size np_name")

#: The wire dtype table. ``code`` is the on-wire u8, ``size`` the
#: element size in bytes, ``np_name`` the numpy dtype the Python side
#: materialises. Mirrored by: Go ``dtypeF32..`` consts + ``dtypeSize``
#: map, R ``.pd_dtype_codes`` / ``.pd_dtype_sizes``, C ``dtype_size()``.
DTYPES = {
    0: WireDtype(0, "float32", 4, "float32"),
    1: WireDtype(1, "int32", 4, "int32"),
    2: WireDtype(2, "int64", 8, "int64"),
    3: WireDtype(3, "bool", 1, "bool"),
}

#: numpy dtype objects by wire code (the server's decode table).
NUMPY_BY_CODE = {c: np.dtype(d.np_name) for c, d in DTYPES.items()}

#: wire code by numpy dtype (the server's encode table).
CODE_BY_NUMPY = {np.dtype(d.np_name): c for c, d in DTYPES.items()}

#: Exact widenings only: these encode as f32 without corruption.
#: Anything else (f64, unsigned, complex, ...) must RAISE, never
#: silently cast — the pre-PR-4 behaviour corrupted i64 token ids
#: through an f32 cast.
WIDEN_TO_F32 = frozenset({"float16", "bfloat16"})


# ------------------------------------------------------------- statuses

WireStatus = namedtuple("WireStatus", "code name terminal doc")

#: Reply status bytes. ``terminal`` is False only for the stream-chunk
#: status: a streaming reply is 0+ status-3 frames then exactly one
#: terminal frame.
STATUSES = {
    0: WireStatus(0, "ok", True,
                  "success; cmd-1 replies carry the output arrays "
                  "(for a stream: the final chunk, possibly empty)"),
    1: WireStatus(1, "error", True,
                  "permanent request error (bad dtype/shape/command); "
                  "retrying the same request cannot succeed"),
    2: WireStatus(2, "retryable", True,
                  "transient: shed by the bounded queue, quarantined "
                  "bucket, scheduler restart, expired deadline, or a "
                  "fleet-topology fault — back off and retry"),
    3: WireStatus(3, "stream", False,
                  "non-final chunk of a streaming decode reply (one "
                  "token array, or a kv-snapshot frame when the "
                  "request set the cadence bits; never sent unless "
                  "the request carried the 0x5C field without its "
                  "one-shot bit)"),
}

STATUS_OK = 0
STATUS_ERROR = 1
STATUS_RETRYABLE = 2
STATUS_STREAM = 3


# ------------------------------------------------------------- commands

WireCommand = namedtuple("WireCommand", "code name request response doc")

#: Request command bytes and their frame grammar (payload = the bytes
#: after the cmd byte).
COMMANDS = {
    1: WireCommand(
        1, "infer",
        "u8 n_inputs | per input: u8 dtype u8 ndim i64 dims[] data | "
        "optional 9-byte marker fields, any order",
        "status + same per-array encoding of the outputs (streaming "
        "decode: status-3 chunk frames then one terminal frame)",
        "run the model (through the batching engine when attached; "
        "0x5C-tagged bodies route to the continuous-batching decode "
        "engine)"),
    3: WireCommand(
        3, "health", "(empty)",
        "status 0 + UTF-8 JSON liveness/readiness body (its `phase` "
        "key declares the replica's pool: prefill | decode | both; "
        "absent means both)",
        "liveness + readiness probe (accepting / draining_deadline_s "
        "announce drains; absent fields mean accepting; `phase` drives "
        "the router's disaggregated prefill/decode placement)"),
    4: WireCommand(
        4, "reload", "optional UTF-8 model prefix (empty = same)",
        "status 0 + UTF-8 JSON, or status 1 + error text",
        "hot model reload: load + warm off to the side, atomic swap, "
        "drain the old engine — zero drops, zero post-swap cold "
        "compiles (serve_model servers only; the router refuses it)"),
    5: WireCommand(
        5, "stats", "(empty)",
        "status 0 + UTF-8 JSON engine counters (decode engines echo "
        "their `phase` alongside the counters)",
        "batching/decode engine counters (per-bucket compiles/hits/"
        "latency, breaker states, queue depth, shed counts)"),
    6: WireCommand(
        6, "metrics", "(empty)",
        "status 0 + Prometheus text exposition 0.0.4",
        "process obs registry exposition (the wire twin of the "
        "serve_model(metrics_port=...) HTTP endpoint)"),
    7: WireCommand(
        7, "stop", "(empty)", "status 0 (ack, then graceful drain)",
        "graceful shutdown: drain in-flight work, close"),
    8: WireCommand(
        8, "drain", "optional f64 drain budget seconds (< 0 = undrain)",
        "status 0 + health JSON",
        "drain announce: health flips accepting=false so routers stop "
        "sending new work, but everything that arrives still serves"),
    9: WireCommand(
        9, "kv_put",
        "one kv-snapshot block (magic, version, JSON header, arrays)",
        "status 0 + UTF-8 JSON echo of the accepted header; status 2 "
        "when the snapshot does not match this replica's identity "
        "(fingerprint/quant/mesh skew); status 1 on a malformed block",
        "validate a KV snapshot against this replica — the stateless "
        "preflight of the resume/handoff flow (the prefill-to-decode "
        "handoff rides the same block format)"),
    10: WireCommand(
        10, "kv_resume",
        "one kv-snapshot block, then optional 9-byte marker fields, "
        "any order (per-token budget, trace id, decode opts/cadence)",
        "streaming decode grammar: status-3 chunk frames carrying the "
        "tokens AFTER the snapshot position, then one terminal frame; "
        "an identity-skewed replica refuses with status 2 before any "
        "chunk",
        "resume a decode stream from a snapshot at its exact sequence "
        "position; the resumed suffix is bitwise identical to an "
        "unbroken solo decode (greedy state is RNG-free)"),
}

CMD_INFER = 1
CMD_HEALTH = 3
CMD_RELOAD = 4
CMD_STATS = 5
CMD_METRICS = 6
CMD_STOP = 7
CMD_DRAIN = 8
CMD_KV_PUT = 9
CMD_KV_RESUME = 10

# -------------------------------------------------- trailing marker fields

WireMarker = namedtuple("WireMarker", "byte name fmt doc")

#: Optional trailing fields on cmd-1 infer bodies. A marker byte (not
#: bare trailing bytes) so garbage tails can't be misread as a field;
#: each field is exactly ``u8 marker + 8 payload bytes``; fields may
#: appear in any order, each marker at most once; parsing stops at the
#: first unknown marker.
MARKERS = {
    0xDD: WireMarker(0xDD, "deadline", "<d",
                     "f64 relative budget in ms; the server computes "
                     "the absolute deadline at receipt and drops the "
                     "request without dispatch once it expires (decode "
                     "requests: the PER-TOKEN budget — TTFT and every "
                     "inter-token gap)"),
    0x1D: WireMarker(0x1D, "trace", "<Q",
                     "u64 non-zero trace id tagging the request's "
                     "obs.tracing spans (enqueue/batch/execute/reply)"),
    0x7E: WireMarker(0x7E, "tenant", "<Q",
                     "u64 tenant id (fleet.tenant_id(name)); the fleet "
                     "router keys WFQ admission and per-tenant SLO "
                     "accounting on it; a direct replica parses and "
                     "ignores it"),
    0x5C: WireMarker(0x5C, "decode", "<Q",
                     "u64 decode opts: low 32 bits max_new_tokens, "
                     "bits 32-47 snapshot cadence (emit a kv-snapshot "
                     "frame every N generated tokens; 0 = never), "
                     "bit 61 speculative decode opt-in (the engine may "
                     "draft-and-verify k tokens per iteration; emitted "
                     "tokens stay bitwise-equal to non-speculative "
                     "greedy, only chunk cadence may change — clients "
                     "that do not set the bit see byte-identical "
                     "streams), bit 62 prefill-handoff (run ONLY the "
                     "prefill step and reply with one status-3 "
                     "kv-snapshot frame then the terminal token frame "
                     "— the router's disaggregated prefill leg), bit "
                     "63 one-shot (collect the whole sequence into a "
                     "single reply instead of a chunk stream)"),
}


DEADLINE_MARKER = 0xDD
TRACE_MARKER = 0x1D
TENANT_MARKER = 0x7E
DECODE_MARKER = 0x5C

#: Bit 63 of the decode field's u64: one-shot single reply.
DECODE_ONESHOT_BIT_SHIFT = 63
DECODE_ONESHOT_BIT = 1 << DECODE_ONESHOT_BIT_SHIFT

#: Bits 32-47 of the decode field's u64: snapshot cadence (emit a
#: kv-snapshot frame every N generated tokens; 0 disables).
DECODE_SNAPSHOT_EVERY_SHIFT = 32
DECODE_SNAPSHOT_EVERY_MASK = 0xFFFF

#: Bit 62 of the decode field's u64: prefill handoff. The server runs
#: ONLY the prefill step (max_new_tokens is forced to 1) and replies
#: deterministically with exactly two frames: one status-3 kv-snapshot
#: frame at n_generated=1, then the terminal status-0 frame carrying
#: the first token. The fleet router's disaggregated prefill leg — a
#: snapshot handed to a decode replica over kv_put/kv_resume continues
#: the stream bitwise-identically to colocated serving.
DECODE_HANDOFF_BIT_SHIFT = 62
DECODE_HANDOFF_BIT = 1 << DECODE_HANDOFF_BIT_SHIFT

#: Bit 61 of the decode field's u64: speculative-decode opt-in. The
#: engine may run a draft model ahead and verify k tokens per
#: iteration in one batched program; greedy accept/reject keeps the
#: emitted tokens bitwise-equal to non-speculative greedy decode, so
#: the only observable change is chunk cadence (several tokens may
#: land in one status-3 frame). Requests WITHOUT the bit decode
#: non-speculatively and their byte streams are identical to a
#: pre-speculation server's — cadence bits only, never content.
DECODE_SPEC_BIT_SHIFT = 61
DECODE_SPEC_BIT = 1 << DECODE_SPEC_BIT_SHIFT

#: Total wire size of one marker field (marker byte + 8 payload bytes).
FIELD_SIZE = 9

# ------------------------------------------------------ codec (Python)

def encode_arrays(arrays):
    """Encode a list of numpy arrays as a cmd-1 array block (u8 count
    then per-array header + row-major data). Exact-widens f16/bf16 to
    f32; raises TypeError on any other unsupported dtype — never a
    silent cast."""
    out = [struct.pack("<B", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(a)
        code = CODE_BY_NUMPY.get(a.dtype)
        if code is None:
            if a.dtype.name in WIDEN_TO_F32:
                a = a.astype(np.float32)  # exact widening, not corruption
                code = CODE_BY_NUMPY[a.dtype]
            else:
                raise TypeError(
                    f"dtype {a.dtype} is not encodable on the wire "
                    "(supported: float32, int32, int64, bool, plus "
                    "f16/bf16 widened to f32)")
        out.append(struct.pack("<BB", code, a.ndim))
        out.append(struct.pack(f"<{a.ndim}q", *a.shape))
        out.append(a.tobytes())
    return b"".join(out)


def decode_arrays_off(payload):
    """Decode a cmd-1 array block; returns (arrays, offset past it)."""
    off = 0
    (n,) = struct.unpack_from("<B", payload, off)
    off += 1
    arrays = []
    for _ in range(n):
        code, ndim = struct.unpack_from("<BB", payload, off)
        off += 2
        dims = struct.unpack_from(f"<{ndim}q", payload, off)
        off += 8 * ndim
        dt = NUMPY_BY_CODE[code]
        count = int(np.prod(dims)) if dims else 1
        arr = np.frombuffer(payload, dt, count, off).reshape(dims)
        off += arr.nbytes
        arrays.append(arr)
    return arrays, off


def decode_arrays(payload):
    return decode_arrays_off(payload)[0]


def encode_deadline(timeout_ms):
    """The optional trailing deadline field (marker 0xDD + f64 ms)."""
    return struct.pack("<Bd", DEADLINE_MARKER, float(timeout_ms))


def encode_decode_opts(max_new_tokens, oneshot=False, snapshot_every=0,
                       handoff=False, speculative=False):
    """The optional trailing decode field (marker 0x5C + u64: low 32
    bits max_new_tokens, bits 32-47 snapshot cadence, bit 61
    speculative opt-in, bit 62 prefill-handoff, bit 63 one-shot)."""
    val = int(max_new_tokens) & 0xFFFFFFFF
    val |= (int(snapshot_every) & DECODE_SNAPSHOT_EVERY_MASK) \
        << DECODE_SNAPSHOT_EVERY_SHIFT
    if speculative:
        val |= DECODE_SPEC_BIT
    if handoff:
        val |= DECODE_HANDOFF_BIT
    if oneshot:
        val |= DECODE_ONESHOT_BIT
    return struct.pack("<BQ", DECODE_MARKER, val)


def decode_request(payload):
    """Decode a cmd-1 infer body: arrays plus the optional trailing
    marker-tagged fields (any order). Returns (arrays,
    budget_seconds_or_None, trace_id_or_None, decode_opts_or_None)
    where decode_opts is ``{"max_new_tokens": n, "oneshot": bool}``.
    Parsing stops at the first unknown marker: old servers ignored
    trailing garbage, and a field this server predates must not be
    misread. The tenant field is parsed and skipped (admission happens
    at the router) so fields AFTER it still parse."""
    arrays, off = decode_arrays_off(payload)
    budget = None
    trace_id = None
    tenant = None
    decode_opts = None
    while len(payload) - off >= FIELD_SIZE:
        marker = payload[off]
        if marker == DEADLINE_MARKER and budget is None:
            (timeout_ms,) = struct.unpack_from("<d", payload, off + 1)
            budget = max(0.0, float(timeout_ms)) / 1000.0
        elif marker == TRACE_MARKER and trace_id is None:
            (tid,) = struct.unpack_from("<Q", payload, off + 1)
            trace_id = tid or None  # 0 = "no trace" on the wire
        elif marker == TENANT_MARKER and tenant is None:
            (tenant,) = struct.unpack_from("<Q", payload, off + 1)
        elif marker == DECODE_MARKER and decode_opts is None:
            (val,) = struct.unpack_from("<Q", payload, off + 1)
            decode_opts = {
                "max_new_tokens": int(val & 0xFFFFFFFF) or None,
                "oneshot": bool(val & DECODE_ONESHOT_BIT),
                "handoff": bool(val & DECODE_HANDOFF_BIT),
                "speculative": bool(val & DECODE_SPEC_BIT),
                "snapshot_every": int(
                    (val >> DECODE_SNAPSHOT_EVERY_SHIFT)
                    & DECODE_SNAPSHOT_EVERY_MASK),
            }
        else:
            break
        off += FIELD_SIZE
    return arrays, budget, trace_id, decode_opts


def build_request(cmd, payload=b""):
    """One complete request frame: u32 body_len | u8 cmd | payload."""
    if cmd not in COMMANDS:
        raise ValueError(f"unknown wire command {cmd}")
    return struct.pack("<IB", 1 + len(payload), cmd) + payload


def build_reply(status, payload=b""):
    """One complete reply frame: u32 body_len | u8 status | payload."""
    if status not in STATUSES:
        raise ValueError(f"unknown wire status {status}")
    return struct.pack("<IB", 1 + len(payload), status) + payload
