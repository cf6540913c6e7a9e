"""Server-Sent Events framing for the HTTP front-end.

Counterpart of ``mxnet_tpu/serving/frontend/sse.py``, the same wire
format. The generate endpoint streams ``TokenStream`` tokens as SSE — the
simplest HTTP-native streaming transport (one long-lived response, no
framing library): each event is ``event: <name>\\ndata: <json>\\n\\n``.
The protocol this front-end speaks:

- ``event: token``  ``data: {"token": <id>, "index": <n>}`` per token
- ``event: done``   terminal; ``data`` carries ``finish_reason``,
  ``request_id`` and the total token count
- ``event: error``  terminal; ``data`` carries the structured
  ``ServingError`` ``code`` + message (mid-stream failures cannot
  change the already-sent 200 status line, so they travel in-band)

``iter_sse`` is the matching parser — used by the tests and the card
script's clients, and a reference for any non-Python consumer.
"""
from __future__ import annotations

import json
from typing import Iterator, Tuple

#: SSE response content type (the other half of the framing contract;
#: metrics' is ``telemetry.CONTENT_TYPE_LATEST``)
SSE_CONTENT_TYPE = "text/event-stream"


def sse_event(event: str, data: dict) -> bytes:
    """One wire-ready SSE frame (compact JSON payload)."""
    return ("event: %s\ndata: %s\n\n"
            % (event, json.dumps(data, separators=(",", ":")))).encode()


def iter_sse(fp) -> Iterator[Tuple[str, dict]]:
    """Parse SSE frames from a binary file-like (e.g. the response of
    ``http.client`` / a socket makefile). Yields ``(event, data)`` pairs
    until EOF; tolerates comment lines (``:``) and multi-``data:``
    frames per the SSE spec (concatenated with newlines before the JSON
    parse)."""
    event, data_lines = "message", []
    for raw in fp:
        line = raw.decode("utf-8").rstrip("\r\n")
        if not line:                      # blank line terminates a frame
            if data_lines:
                yield event, json.loads("\n".join(data_lines))
            event, data_lines = "message", []
            continue
        if line.startswith(":"):          # comment / keep-alive
            continue
        field, _, value = line.partition(":")
        value = value[1:] if value.startswith(" ") else value
        if field == "event":
            event = value
        elif field == "data":
            data_lines.append(value)
    if data_lines:                        # EOF without trailing blank line
        yield event, json.loads("\n".join(data_lines))
