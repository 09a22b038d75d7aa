"""Workflow events: durable external triggers.

A copy of ``ray_tpu.workflow.event_listener`` for the PyTorch port.

Parity: reference ``python/ray/workflow/event_listener.py`` +
``api.py:364`` (``wait_for_event``): an :class:`EventListener` polls an
external source inside a workflow step; a second step commits the
checkpoint acknowledgment.  Because every step RESULT is checkpointed
by the execution engine, a workflow resumed after a crash past the
event step replays the recorded event instead of re-polling —
exactly-once consumption relative to the workflow's progress.

The reference's listeners are asyncio coroutines on an event fleet;
here they are plain callables on the step executor (the runtime's
steps are sync tasks), with identical semantics.
"""

from __future__ import annotations

import time
from typing import Any

Event = Any


class EventListener:
    """Subclass and pass the TYPE to :func:`wait_for_event` (the
    listener is instantiated inside the polling step, on whatever node
    runs it)."""

    def poll_for_event(self, *args, **kwargs) -> Event:
        """Block until the event arrives; return its payload."""
        raise NotImplementedError

    def event_checkpointed(self, event: Event) -> None:
        """Called after the event is durably recorded in workflow
        storage — acknowledge/commit upstream (e.g. ack a queue
        message) here."""


class TimerListener(EventListener):
    """Fires once ``timestamp`` (unix seconds) has passed (reference
    ``TimerListener``)."""

    def poll_for_event(self, timestamp: float) -> Event:
        while time.time() < timestamp:
            time.sleep(min(0.1, max(0.0, timestamp - time.time())))
        return timestamp


def wait_for_event(event_listener_type, *args, **kwargs):
    """A step node resolving to the event payload (reference
    ``api.py:364``): poll step -> commit step, both checkpointed."""
    from ray_tpu_torch.workflow import step

    if not (isinstance(event_listener_type, type) and
            issubclass(event_listener_type, EventListener)):
        raise TypeError(
            f"{event_listener_type!r} is not an EventListener subclass")

    @step
    def get_message(listener_type, *a, **kw) -> Event:
        return listener_type().poll_for_event(*a, **kw)

    @step
    def message_committed(listener_type, event: Event) -> Event:
        # Runs only after get_message's result is checkpointed — the
        # commit callback can safely ack the external source.
        listener_type().event_checkpointed(event)
        return event

    return message_committed.step(
        event_listener_type,
        get_message.step(event_listener_type, *args, **kwargs))
