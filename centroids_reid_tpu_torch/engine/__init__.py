"""Training, evaluation and run orchestration. Import the submodules
(``engine.fit``, ``engine.steps``, ``engine.checkpoint``,
``engine.evaluate``, ``engine.runner``, ...) directly; importing the
package loads nothing."""
