"""The traffic kinds, one module each, named by a traffic file's
``loop``: each defines ``run(ctx) -> harness.Record``."""
