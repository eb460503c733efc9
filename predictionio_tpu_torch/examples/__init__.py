"""The example engines, run with `python -m
predictionio_tpu_torch.examples.<name>`: `local_engines` (helloworld and
regression), `friend_recommendation` (keyword similarity and SimRank),
`stock_backtesting` (batched per-ticker OLS and a walk-forward backtest)
and `quickstart` (every template family end to end). Each takes
`--device` (default: the card)."""
