"""Host ms a batch spends building its slot pack (``SlotPack.build`` and the
pair check ``is_pair_shared``) and emitting its relations
(``infer.relations_of``), mean over the traced run's window."""


def read(o):
    rel = o.spans.get("relations")
    if not rel:
        return None
    return (sum(o.spans.get("pack", [])) + sum(o.spans.get("pack_check", [])) + sum(rel)) / len(rel)
