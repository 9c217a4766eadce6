"""The yardstick's arithmetic: peaks, kernel work, model FLOPs."""
