"""Host-side orchestration: options and the Monte-Carlo point executor."""
