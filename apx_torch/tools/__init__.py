"""Host tools of the port: trace summaries, env docs and rollout GIFs."""
