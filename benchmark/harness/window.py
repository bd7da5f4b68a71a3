"""The measured window: a closed loop of independent batches through
`Aligner.align_stream`, until the first batch completion at or after the
run's length. The window holds only whole batches, so a stall anywhere
in it counts."""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Done:
    k: int              # batch index
    submit: float       # host clock when the stream took the batch
    done: float         # host clock when its bytes came back
    reads: int


@dataclasses.dataclass
class Window:
    t0: float
    done: list[Done]
    outputs: dict[int, bytes]

    def close(self, seconds: float) -> Done | None:
        """The first completion at or after `seconds`; None if the stream
        ended first."""
        return next((d for d in self.done if d.done - self.t0 >= seconds),
                    None)

    def counted(self, seconds: float) -> list[Done]:
        """The batches of the window: every completion up to its close."""
        c = self.close(seconds)
        return [d for d in self.done if c is not None and d.done <= c.done]

    def reads_per_s(self, seconds: float) -> float:
        c = self.close(seconds)
        return sum(d.reads for d in self.counted(seconds)) / (c.done - self.t0)


def run(aligner, batches, seconds: float, depth: int, drain: bool,
        clock=time.perf_counter) -> Window:
    """Feed batch 0, 1, ... until the window closes. Without `drain` the
    loop stops reading at the close (the batches still in flight finish
    before this returns, uncounted); with it, they are read too."""
    stop = False
    submit: dict[int, float] = {}

    def feed():
        k = 0
        while not stop:
            b = batches[k]
            submit[k] = clock()
            yield b
            k += 1

    win = Window(t0=clock(), done=[], outputs={})
    stream = aligner.align_stream(feed(), depth=depth)
    try:
        for k, out in enumerate(stream):
            t = clock()
            win.done.append(Done(k, submit[k], t, len(batches[k][1])))
            win.outputs[k] = out
            if not stop and t - win.t0 >= seconds:
                stop = True
                if not drain:
                    break
    finally:
        stream.close()
    return win
