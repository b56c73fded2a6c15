"""layout_s: seconds of the layout build, ``get_device_graph()`` in set-up
(``ops/layout.py:build_device_csr``, ``ops/hubs.py``), host clock with a
synchronize."""


def read(ctx):
    return ctx["layout_s"]
