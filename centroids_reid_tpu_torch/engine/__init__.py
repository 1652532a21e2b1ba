"""Evaluation and run orchestration. Import the submodules
(``engine.evaluate``, ``engine.runner``, ``engine.logging``) directly;
importing the package loads nothing."""
