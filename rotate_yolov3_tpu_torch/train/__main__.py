from .cli import make_parser, train

train(make_parser().parse_args())
