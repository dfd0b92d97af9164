"""Launchers, the port of ``repro.launch``: the one-device train step
(``steps``) and trainer (``train``). The mesh, dry-run and serving launchers
come with ROADMAP §1 items 7-9."""
