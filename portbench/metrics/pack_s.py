"""``pack_s``: host seconds of both sides' ``build_bucketed`` in set-up
(the native ``alspack`` fill pass and the layout planning around it)."""


def read(run):
    return run.spans.get("pack")
