"""tail_ms.segment: the median over the traced recordings of the program's
``segment.tail`` span, from the last device result on the host to the
return of ``segment()`` / ``segment_from_frames()`` (parse, merge,
consolidation, blur and duplicates, post-processing, frame tracks), in
ms."""

from perfbench.spans import median, ms, records


def read(view):
    tails = records(view, "segment.tail")
    if tails is None:
        return None
    per_request = {}
    for r in tails:
        per_request[r.request_id] = per_request.get(r.request_id, 0.0) + ms(r)
    return median(list(per_request.values()))
