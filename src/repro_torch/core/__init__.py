"""The paper's stream model in PyTorch: bus words, activity, BIC, ZVG,
the SA coding menu and the calibrated energy model."""
