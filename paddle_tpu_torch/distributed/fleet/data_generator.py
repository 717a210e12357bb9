"""Fleet data generators for the PS/CTR text pipeline
(``paddle_tpu/distributed/fleet/data_generator.py``, copied; reference:
python/paddle/distributed/fleet/data_generator/data_generator.py —
DataGenerator :20, MultiSlotDataGenerator :~120 `_gen_str` "ids_num id1
id2 ..." MultiSlotDataFeed wire format, MultiSlotStringDataGenerator).

The generators are pure-python line formatters: ``generate_sample``
(rewritten by the user) yields ``[(slot_name, [values...]), ...]`` per
input line; ``run_from_stdin`` streams stdin lines through it and
prints the slot-serialized samples for the dataset pipeline
(paddle.distributed.InMemoryDataset/QueueDataset consume this format).
"""
from __future__ import annotations

import sys


class DataGenerator:
    """reference: data_generator.py:20."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        """User hook: return a zero-arg iterator yielding
        [(slot_name, [values...]), ...] per sample."""
        raise NotImplementedError(
            "generate_sample() must be implemented by the subclass")

    def generate_batch(self, samples):
        """Optional user hook for batch-level post-processing."""
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError(
            "_gen_str is provided by MultiSlot[String]DataGenerator")

    def run_from_stdin(self):
        """Stream stdin → serialized samples on stdout (the launch
        pipeline's `cat data | python my_generator.py` contract)."""
        batch_samples = []
        for line in sys.stdin:
            it = self.generate_sample(line)
            for sample in it():
                if sample is None:
                    continue
                batch_samples.append(sample)
                if len(batch_samples) == self.batch_size_:
                    for s in self.generate_batch(batch_samples)():
                        sys.stdout.write(self._gen_str(s))
                    batch_samples = []
        for s in self.generate_batch(batch_samples)():
            sys.stdout.write(self._gen_str(s))

    def run_from_memory(self):
        """Debug variant: generate_sample(None) once, print samples."""
        it = self.generate_sample(None)
        for sample in it():
            if sample is not None:
                sys.stdout.write(self._gen_str(sample))


def _check_slots(line):
    if isinstance(line, zip):
        line = list(line)
    if not isinstance(line, (list, tuple)):
        raise ValueError(
            "the output of process() must be in list or tuple type "
            "Example: [('words', [1926, 8, 17]), ('label', [1])]")
    return line


class MultiSlotDataGenerator(DataGenerator):
    """Numeric slots → "ids_num id1 id2 ..." per slot (reference
    _gen_str :137; proto_info tracks uint64/float per slot)."""

    def _gen_str(self, line):
        line = _check_slots(line)
        if self._proto_info is None:
            self._proto_info = []
            for name, values in line:
                kind = "float" if any(isinstance(v, float) for v in values) \
                    else "uint64"
                self._proto_info.append((name, kind))
        elif len(line) != len(self._proto_info):
            raise ValueError("the complete field set of two given lines "
                             "are inconsistent.")
        out = []
        for name, values in line:
            if not values:
                raise ValueError(f"the value of slot {name} is empty")
            out.append(str(len(values)))
            out.extend(str(v) for v in values)
        return " ".join(out) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    """String slots → "ids_num str1 str2 ..." per slot (reference
    MultiSlotStringDataGenerator._gen_str :240)."""

    def _gen_str(self, line):
        line = _check_slots(line)
        out = []
        for name, values in line:
            if not values:
                raise ValueError(f"the value of slot {name} is empty")
            out.append(str(len(values)))
            out.extend(str(v) for v in values)
        return " ".join(out) + "\n"
