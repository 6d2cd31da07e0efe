"""Launchers: training (``train``: pipeline, microbatched steps, async
checkpoints, restart) and greedy serving (``serve``)."""
