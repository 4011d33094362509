"""Twins of the reference's ``examples/``, runnable as modules.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.remote_paging_demo [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_paged [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.capacity_plan [spec.json]

Each has ``main(argv=None)``, runs on ``cuda`` unless ``--device cpu`` is
given, asserts its own results and prints the reference's closing line.
"""
