"""DataFeedDesc (reference: python/paddle/fluid/data_feed_desc.py +
framework/data_feed.proto). Parses the reference's textproto format —
name, batch_size, multi_slot_desc { slots { name type is_dense is_used } }
— without a protobuf dependency (the grammar the reference uses is a
two-level block structure with scalar fields). Port of
``paddle_tpu/data_feed_desc.py``."""

import re

__all__ = ["DataFeedDesc"]


class _Slot:
    def __init__(self, name, type="uint64", is_dense=False, is_used=False):
        self.name = name
        self.type = type
        self.is_dense = is_dense
        self.is_used = is_used


_FIELD = re.compile(r'(\w+)\s*:\s*("([^"]*)"|\S+)')


class DataFeedDesc:
    """(reference: data_feed_desc.py:30) — accepts a textproto string or
    a path to one."""

    def __init__(self, proto_file):
        try:
            with open(proto_file) as f:
                text = f.read()
        except (OSError, ValueError):
            text = proto_file
        self.name = "MultiSlotDataFeed"
        self.batch_size = 32
        self.slots = []
        self._parse(text)

    def _parse(self, text):
        # split slot blocks first, then scalars outside them
        for m in re.finditer(r"slots\s*\{([^}]*)\}", text):
            body = m.group(1)
            # findall yields '' (not None) for the unmatched quoted group
            kv = {k: (s if s else v) for k, v, s in _FIELD.findall(body)}
            self.slots.append(_Slot(
                name=kv.get("name", ""),
                type=kv.get("type", "uint64"),
                is_dense=kv.get("is_dense", "false") == "true",
                is_used=kv.get("is_used", "false") == "true"))
        outside = re.sub(r"multi_slot_desc\s*\{.*\}", "", text,
                         flags=re.S)
        for k, v, s in _FIELD.findall(outside):
            if k == "name":
                self.name = s if s else v
            elif k == "batch_size":
                self.batch_size = int(v)

    # -- reference mutation API -------------------------------------------
    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        names = set(dense_slots_name)
        for s in self.slots:
            if s.name in names:
                s.is_dense = True

    def set_use_slots(self, use_slots_name):
        names = set(use_slots_name)
        for s in self.slots:
            if s.name in names:
                s.is_used = True

    def used_slots(self):
        return [s for s in self.slots if s.is_used]

    def desc(self):
        lines = ['name: "%s"' % self.name,
                 "batch_size: %d" % self.batch_size,
                 "multi_slot_desc {"]
        for s in self.slots:
            lines += ["   slots {",
                      '       name: "%s"' % s.name,
                      '       type: "%s"' % s.type,
                      "       is_dense: %s" % str(s.is_dense).lower(),
                      "       is_used: %s" % str(s.is_used).lower(),
                      "   }"]
        lines.append("}")
        return "\n".join(lines)
