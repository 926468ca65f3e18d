"""Launch layer of the port: the end-to-end training entry point
(``python -m repro_torch.launch.train``).  Port of the training modes of
``src/repro/launch/``; serving, ``steps.py`` and the mesh, sharding and
dry-run tools come with ROADMAP Queue A, item 11."""
